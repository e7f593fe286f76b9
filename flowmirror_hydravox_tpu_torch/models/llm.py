"""Multi-head (MTP) speech-token LM: port of
flowmirror_hydravox_tpu/models/llm.py (decode and training).

  - MTP heads in the reduced length-1 form (`_mtp_head_apply`): a Qwen2
    decoder layer applied to one position reduces to
        h = x + o_proj(v_proj(rms_1(x)));  y = h + mlp(rms_2(h)).
  - KV-cached group decode: each step samples K = inference_head_num tokens
    against the same history, accepts them up to the first stop id, and runs
    one backbone forward over the K accepted tokens.
  - The flash batch (`generate_batched`): B utterances decode together with
    per-row lengths and stops, sharing each weight read; its step,
    `decode_step_batched`, is also the continuous batcher's.
  - Self-speculative MTP decoding (`generate_speculative`,
    `generate_spec_until`, `generate_batched_speculative`; llm.py:507-914):
    heads 1..K-1 draft the next K-1 tokens from the last cached hidden, one
    backbone forward over [pend, drafts] verifies them against head 0, and
    the step emits the accepted drafts, then a token from the residual or a
    bonus token. The output has the heads=1 distribution, and greedy output
    is heads=1's token for token. Its step, `spec_step_batched`, serves the
    solo loop, the flash batch and the continuous slots.

Every decode-step MLP (the MTP heads' and the backbone's) goes through
`ops.mlp_gemv.mlp_gemv`, the fused SwiGLU GEMV kernel on the card; the
prompt prefill's MLP stays torch.matmul. On a weight-only int8 tree
(ops/quant.py) the MLP takes the kernel's int8 form and every other product
against an LLM leaf (the heads' v/o projections, `llm_decoder`) goes through
`matmul_q`.

Training (`forward_loss`, JAX :122-256) runs the backbone's full causal
`qwen2.forward` and the heads' training form, whose MLP is
`qwen2._mlp_block`: the kernels have no backward, so no training forward
reaches them.

The decode loops are Python loops with one host read per step (the sampled
ids): it decides how many tokens to accept and whether to stop, as the JAX
`lax.while_loop` body does on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import LLMConfig
from ..ops.quant import matmul_q
from ..params import unstack
from ..ops.sampling import (SamplingParams, ras_dist_rows, ras_sample_heads,
                            ras_sample_heads_batched, sample_dist)
from . import qwen2

CACHE_ROUND = 256  # cache lengths round up to a multiple of this
IGNORE_ID = -1  # a target no head is scored on


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (max_tokens,) int32 on the device, valid prefix only;
    # (B, max_tokens) from generate_batched
    num_tokens: int  # a list of B ints from generate_batched
    steps: int  # base-LLM step count (for TPS metrics)


class SpecResult(NamedTuple):
    result: GenerateResult
    accepted: int  # drafts accepted (summed over a flash batch's rows)
    drafted: int  # drafts proposed


def _mtp_head_apply(head: dict, x, eps: float, decode_step: bool = True):
    """Single head, pointwise. x: (..., H) -> (..., H). A decode step's MLP
    goes through `qwen2.decode_mlp` (the kernel on the card); training's
    (`decode_step=False`) through `qwen2._mlp_block`, differentiable
    torch.matmul, as JAX llm.py:94-95 computes it."""
    attn_in = qwen2._rms_norm(x, head["input_layernorm"], eps)
    v = matmul_q(attn_in, head, "v_proj_w") + head["v_proj_b"]
    x = x + matmul_q(v, head, "o_proj_w")
    mlp_in = qwen2._rms_norm(x, head["post_attention_layernorm"], eps)
    mlp = qwen2.decode_mlp if decode_step else qwen2._mlp_block
    return x + mlp(head, mlp_in)


def mtp_logits(params: dict, cfg: LLMConfig, hidden, num_heads: int, first: int = 0,
               decode_step: bool = True):
    """Heads first..first+num_heads-1 and the shared decoder:
    (..., H) -> (num_heads, ..., V) f32. `decode_step=False` is the training
    form (see `_mtp_head_apply`)."""
    eps = cfg.backbone.rms_norm_eps
    heads = unstack({k: v[first:first + num_heads] for k, v in params["mtp_block"].items()})
    outs = [_mtp_head_apply(head, hidden, eps, decode_step) for head in heads]
    return matmul_q(torch.stack(outs), params, "llm_decoder").to(torch.float32)


# ---------------------------------------------------------------------------
# Training: input/target construction and the multi-head CE loss
# (JAX llm.py:122-256)


def build_lm_input(params: dict, cfg: LLMConfig, text_token, text_len, speech_token,
                   speech_len):
    """[sos, text_emb, task, speech_emb] per row, padded with the eos
    embedding (llm_multi_head_v3.py:723-747). text_token (B, Lt) and
    speech_token (B, Ls) right-padded, lengths (B,). Returns
    (lm_input (B, 2 + Lt + Ls, H), lm_input_len (B,))."""
    b, lt = text_token.shape
    ls = speech_token.shape[1]
    dev = text_token.device
    text_emb = qwen2.embed_tokens(params["backbone"], torch.clamp(text_token, min=0))
    table = params["speech_embedding"]
    speech_emb = table[torch.clamp(speech_token, 0, table.shape[0] - 1).long()]
    sos, task, eos = table[cfg.sos], table[cfg.task_id], table[cfg.eos_token]

    pos = torch.arange(2 + lt + ls, device=dev)[None, :]  # (1, T)
    tlen = text_len.to(dev).long()[:, None]
    slen = speech_len.to(dev).long()[:, None]
    rows = torch.arange(b, device=dev)[:, None]
    text = text_emb[:, torch.clamp(pos[0] - 1, 0, lt - 1)]
    speech = speech_emb[rows, torch.clamp(pos - tlen - 2, 0, ls - 1)]
    out = torch.where(
        (pos == 0)[..., None], sos,
        torch.where(
            ((pos >= 1) & (pos <= tlen))[..., None], text,
            torch.where(
                (pos == tlen + 1)[..., None], task,
                torch.where(((pos >= tlen + 2) & (pos < tlen + 2 + slen))[..., None],
                            speech, eos))))
    return out.to(text_emb.dtype), 2 + text_len + speech_len


def build_lm_targets(cfg: LLMConfig, text_len, speech_token, speech_len, t_total: int):
    """Per-head shifted targets (llm_multi_head_v3.py:749-762): head k at
    position p predicts speech token p - (1 + tlen) + k, one eos after the
    last speech target, IGNORE_ID elsewhere. Returns (head_num, B, T)."""
    ls = speech_token.shape[1]
    dev = speech_token.device
    pos = torch.arange(t_total, device=dev)[None, :]
    tlen = text_len.to(dev).long()[:, None]
    slen = speech_len.to(dev).long()[:, None]
    rows = torch.arange(speech_token.shape[0], device=dev)[:, None]
    heads = []
    for k in range(cfg.head_num):
        sidx = pos - (1 + tlen) + k
        in_speech = (pos >= 1 + tlen) & (sidx < slen)
        is_eos = pos == (1 + tlen) + (slen - k)
        tok = speech_token[rows, torch.clamp(sidx, 0, ls - 1)].long()
        heads.append(torch.where(in_speech, tok, torch.where(
            is_eos, torch.full_like(tok, cfg.eos_token), torch.full_like(tok, IGNORE_ID))))
    return torch.stack(heads)


def forward_loss(params: dict, cfg: LLMConfig, text_token, text_len, speech_token,
                 speech_len) -> dict:
    """Training loss: the mean over heads of the label-smoothed CE on the
    shifted targets (llm_multi_head_v3.py:766-828), in the logsumexp form.
    Returns {'loss', 'acc'} (f32 scalars). Goes through no kernel: the
    backbone's `forward` and the heads' training form."""
    lm_input, lm_len = build_lm_input(params, cfg, text_token, text_len, speech_token,
                                      speech_len)
    hidden = qwen2.forward(params["backbone"], cfg.backbone, lm_input, lm_len)
    logits = mtp_logits(params, cfg, hidden, cfg.head_num, decode_step=False)  # (K, B, T, V)
    targets = build_lm_targets(cfg, text_len, speech_token, speech_len, lm_input.shape[1])

    valid = targets != IGNORE_ID
    tgt = torch.clamp(targets, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, tgt[..., None])[..., 0]
    if cfg.lsm_weight > 0:
        # KL(uniform-smoothed || pred), as WeNet's LabelSmoothingLoss
        smooth = lse - torch.mean(logits, dim=-1)
        nll = (1.0 - cfg.lsm_weight) * nll + cfg.lsm_weight * smooth
    denom = torch.clamp(valid.sum(dim=(1, 2)), min=1)  # per-head token count
    if not cfg.length_normalized_loss:
        denom = torch.full_like(denom, targets.shape[1])
    per_head_loss = torch.where(valid, nll, 0.0).sum(dim=(1, 2)) / denom
    hit = valid & (torch.argmax(logits, dim=-1) == tgt)
    per_head_acc = hit.sum(dim=(1, 2)) / denom
    return {"loss": per_head_loss.mean(), "acc": per_head_acc.to(torch.float32).mean()}


def build_inference_prompt(params: dict, cfg: LLMConfig, text_token, text_len: int,
                           prompt_speech_token, prompt_speech_len: int):
    """[sos, text_emb, task, prompt_speech_emb] (llm_multi_head_v3.py:941-952),
    padded to (2 + Lt + Lp, H) as the JAX function pads it. Returns
    (embeds, true_len)."""
    dev = text_token.device
    lt, lp = text_token.shape[0], prompt_speech_token.shape[0]
    t_total = 2 + lt + lp
    text_emb = qwen2.embed_tokens(params["backbone"], torch.clamp(text_token, min=0))
    speech_table = params["speech_embedding"]
    speech_emb = speech_table[torch.clamp(prompt_speech_token, 0, speech_table.shape[0] - 1).long()]
    sos = speech_table[cfg.sos]
    task = speech_table[cfg.task_id]

    pos = torch.arange(t_total, device=dev)
    tlen = int(text_len)
    text_idx = torch.clamp(pos - 1, 0, lt - 1)
    speech_idx = torch.clamp(pos - tlen - 2, 0, max(lp - 1, 0))
    tail = speech_emb[speech_idx] if lp > 0 else torch.zeros_like(sos)[None, :]
    out = torch.where(
        (pos == 0)[:, None], sos[None, :],
        torch.where(
            ((pos >= 1) & (pos <= tlen))[:, None], text_emb[text_idx],
            torch.where((pos == tlen + 1)[:, None], task[None, :], tail),
        ),
    )
    return out.to(text_emb.dtype), 2 + tlen + int(prompt_speech_len)


def _prefill(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len, *, max_tokens: int,
             head_k: int, cache_len_cap: Optional[int]):
    """A KV cache of B rows with each row's prompt written and committed.
    prompt_embeds (B, T, H) padded, prompt_len B ints; the cache holds
    `cache_len_cap` rows (default T + max_tokens + K) rounded up to
    CACHE_ROUND. Returns (hidden (B, T, H), cache)."""
    b, t_prompt, _ = prompt_embeds.shape
    if cache_len_cap is None:
        cache_len_cap = t_prompt + max_tokens + head_k
    cap = -(-cache_len_cap // CACHE_ROUND) * CACHE_ROUND
    if t_prompt > cap:  # jax.lax.dynamic_update_slice would clamp the write
        raise ValueError(f"prompt block of {t_prompt} exceeds the cache of {cap}")
    dev = prompt_embeds.device
    cache = qwen2.init_kv_cache(cfg.backbone, b, cap, dtype=prompt_embeds.dtype, device=dev)
    return qwen2.forward_block_with_cache(
        params["backbone"], cfg.backbone, prompt_embeds, cache,
        advance=torch.tensor([int(n) for n in prompt_len], dtype=torch.int32, device=dev),
    )


def init_generate_state(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len: int, *,
                        inference_head_num: int, max_tokens: int = 1024,
                        cache_len_cap: Optional[int] = None) -> dict:
    """Prefill the KV cache and build the decode-loop state."""
    head_k = max(1, min(int(inference_head_num), cfg.head_num))
    dev = prompt_embeds.device
    hidden, cache = _prefill(params, cfg, prompt_embeds[None], [prompt_len],
                             max_tokens=max_tokens, head_k=head_k, cache_len_cap=cache_len_cap)
    return dict(
        cache=cache,
        cache_pos=int(prompt_len),  # host copy of cache.length[0]
        last_hidden=hidden[0, int(prompt_len) - 1],
        tokens=torch.full((max_tokens + head_k,), -1, dtype=torch.int32, device=dev),
        num=0,
        steps=0,
        finished=False,
    )


def generate_until(params: dict, cfg: LLMConfig, state: dict, target_num: int, min_len: int,
                   max_len: int, sampling: SamplingParams, noise, *,
                   inference_head_num: int) -> dict:
    """Run group-decode steps until `target_num` tokens exist or generation
    finishes. `noise.sampling(k, vocab)` gives each step's Gumbel noise."""
    head_k = max(1, min(int(inference_head_num), cfg.head_num))
    bb = cfg.backbone
    speech_table = params["speech_embedding"]
    s_max = state["cache"].k.shape[2]
    while not state["finished"] and state["num"] < target_num:
        gumbel_nuc, gumbel_flat = noise.sampling(head_k, cfg.vocab_size)
        logits = mtp_logits(params, cfg, state["last_hidden"], head_k)  # (K, V)
        sampled = ras_sample_heads(
            logits, state["tokens"], state["num"], sampling, min_len,
            cfg.speech_token_size, gumbel_nuc, gumbel_flat,
        )
        ids = sampled.tolist()  # the step's one host read
        n_ok = next((j for j, tok in enumerate(ids) if tok >= cfg.speech_token_size), head_k)
        num = state["num"]
        n_accept = min(n_ok, max(max_len - num, 0))
        state["tokens"][num:num + n_accept] = sampled[:n_accept].to(torch.int32)
        num += n_accept
        finished = n_ok < head_k or num >= max_len or n_accept == 0
        if not finished:
            if state["cache_pos"] + head_k > s_max:
                raise ValueError(f"decode block at {state['cache_pos']} overruns the cache of {s_max}")
            emb = speech_table[sampled][None]
            hidden, state["cache"] = qwen2.forward_block_with_cache(
                params["backbone"], bb, emb, state["cache"],
                advance=torch.full((1,), head_k, dtype=torch.int32, device=emb.device),
                decode_step=True,
            )
            state["cache_pos"] += head_k
            state["last_hidden"] = hidden[0, head_k - 1]
        state.update(num=num, steps=state["steps"] + 1, finished=finished)
    return state


def generate(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len: int, min_len: int,
             max_len: int, sampling: SamplingParams, noise, *, inference_head_num: int,
             max_tokens: int = 1024, cache_len_cap: Optional[int] = None) -> GenerateResult:
    """Multi-head AR decode (llm_multi_head_v3.py:861-922), KV-cached."""
    state = init_generate_state(
        params, cfg, prompt_embeds, prompt_len, inference_head_num=inference_head_num,
        max_tokens=max_tokens, cache_len_cap=cache_len_cap,
    )
    state = generate_until(params, cfg, state, max_len, min_len, max_len, sampling, noise,
                           inference_head_num=inference_head_num)
    return GenerateResult(tokens=state["tokens"][:max_tokens], num_tokens=state["num"],
                          steps=state["steps"])


def generate_batched(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len, min_len, max_len,
                     sampling: SamplingParams, noise, *, inference_head_num: int,
                     max_tokens: int = 1024, cache_len_cap: Optional[int] = None) -> GenerateResult:
    """The flash batch (llm.py:410-504): B utterances decode in one loop with
    per-row stops and lengths; the loop runs until every row has finished.

    prompt_embeds (B, T, H) padded; prompt_len, min_len, max_len: B ints.
    `noise.sampling_batch(b, k, vocab)` gives each step's Gumbel noise.
    Returns tokens (B, max_tokens), num_tokens (list of B ints), steps.
    Each step is `decode_step_batched`; the step in which the last row
    finishes runs no forward (the same rule as `generate_until`)."""
    head_k = max(1, min(int(inference_head_num), cfg.head_num))
    b = prompt_embeds.shape[0]
    dev = prompt_embeds.device
    prompt_len = [int(n) for n in prompt_len]
    hidden, cache = _prefill(params, cfg, prompt_embeds, prompt_len, max_tokens=max_tokens,
                             head_k=head_k, cache_len_cap=cache_len_cap)
    rows = torch.arange(b, device=dev)
    state = dict(
        cache=cache,
        last_hidden=hidden[rows, torch.tensor(prompt_len, device=dev) - 1],  # (B, H)
        tokens=torch.full((b, max_tokens + head_k), -1, dtype=torch.int32, device=dev),
        num=[0] * b, finished=[False] * b, max_len=[int(n) for n in max_len],
        num_t=torch.zeros(b, dtype=torch.int64, device=dev),
        min_len_t=torch.tensor([int(n) for n in min_len], device=dev),
    )
    steps = 0
    while not all(state["finished"]):
        gumbel_nuc, gumbel_flat = noise.sampling_batch(b, head_k, cfg.vocab_size)
        decode_step_batched(params, cfg, state, sampling, gumbel_nuc, gumbel_flat, head_k=head_k)
        steps += 1
    return GenerateResult(tokens=state["tokens"][:, :max_tokens], num_tokens=state["num"],
                          steps=steps)


def decode_step_batched(params: dict, cfg: LLMConfig, state: dict, sampling: SamplingParams,
                        gumbel_nuc, gumbel_flat, *, head_k: int) -> bool:
    """One group-decode step over the B rows of `state`, the body of the flash
    batch's loop and of a continuous-batching chunk (runtime/continuous.py).

    state: cache (KVCache of B rows), last_hidden (B, H), tokens (B, L) int32,
    num_t (B,) and min_len_t (B,) integer tensors on the device; num,
    finished, max_len: B host ints/bools, the host's copy of the row state.
    Updated in place. gumbel_nuc (B, K, KMAX), gumbel_flat (B, K, V).

    The MTP heads and the batched RAS draw run for all rows (finished rows
    draw too and accept nothing, as the JAX vmap does); one host read of the
    (B, K) ids; per row, the stop-inside-group rule and the `max_len` budget;
    then one backbone forward over the (B, K) block, in which finished rows
    advance 0 and keep their `last_hidden`. A step after which every row has
    finished runs no forward: the JAX loops run it (llm.py:489,
    continuous.py:394), but its hidden states and cache rows are never read,
    so skipping it changes no result. Returns whether the forward ran."""
    sts = cfg.speech_token_size
    logits = mtp_logits(params, cfg, state["last_hidden"], head_k).transpose(0, 1)  # (B, K, V)
    sampled = ras_sample_heads_batched(
        logits, state["tokens"], state["num_t"], sampling, state["min_len_t"], sts,
        gumbel_nuc, gumbel_flat,
    )
    ids = sampled.tolist()  # the step's one host read
    num, finished, max_len = state["num"], state["finished"], state["max_len"]
    for r, row in enumerate(ids):
        n_ok = next((j for j, tok in enumerate(row) if tok >= sts), head_k)
        n_accept = 0 if finished[r] else min(n_ok, max(max_len[r] - num[r], 0))
        if n_accept:
            state["tokens"][r, num[r]:num[r] + n_accept] = sampled[r, :n_accept].to(torch.int32)
        num[r] += n_accept
        finished[r] = finished[r] or n_ok < head_k or num[r] >= max_len[r] or n_accept == 0
    if all(finished):
        return False
    # the row state goes back in one copy, while the device is idle after the
    # read above
    num_t, done = torch.tensor([num, finished], dtype=torch.int64, device=sampled.device)
    done = done.bool()
    hidden, state["cache"] = qwen2.forward_block_with_cache(
        params["backbone"], cfg.backbone, params["speech_embedding"][sampled], state["cache"],
        advance=torch.where(done, 0, head_k).to(torch.int32), decode_step=True,
    )
    state["num_t"] = num_t
    state["last_hidden"] = torch.where(done[:, None], state["last_hidden"], hidden[:, head_k - 1])
    return True


# -- self-speculative MTP decoding (llm.py:507-914) ----------------------------


def _spec_head_k(num_heads: int, cfg: LLMConfig) -> int:
    """The block size K: one pending token and K-1 drafts (llm.py:526)."""
    return max(2, min(int(num_heads), cfg.head_num))


def spec_state(cache, last_hidden, prompt_len, min_len, max_len, *, max_tokens: int,
               head_k: int, finished=None) -> dict:
    """The decode state of B rows that `spec_step_batched` advances: the
    B-row cache with each row's prompt prefilled (`prompt_len` B host ints),
    last_hidden (B, H); the device tensors tokens (B, max_tokens + K) int32,
    pend_t, num_t, min_len_t, max_len_t (B,) int64 and done_t (B,) bool; and
    the host's copy: num, finished, max_len, cache_pos (the cache length),
    accepted and drafted, B each, and steps. `pend` is the newest emitted
    token, counted in tokens/num but not yet in the cache (llm.py:897)."""
    b = last_hidden.shape[0]
    dev = last_hidden.device
    finished = [False] * b if finished is None else list(finished)
    return dict(
        cache=cache, last_hidden=last_hidden,
        tokens=torch.full((b, max_tokens + head_k), -1, dtype=torch.int32, device=dev),
        pend_t=torch.zeros(b, dtype=torch.int64, device=dev),
        num_t=torch.zeros(b, dtype=torch.int64, device=dev),
        min_len_t=torch.tensor([int(n) for n in min_len], dtype=torch.int64, device=dev),
        max_len_t=torch.tensor([int(n) for n in max_len], dtype=torch.int64, device=dev),
        done_t=torch.tensor(finished, dtype=torch.bool, device=dev),
        num=[0] * b, finished=finished, max_len=[int(n) for n in max_len],
        cache_pos=[int(n) for n in prompt_len], accepted=[0] * b, drafted=[0] * b, steps=0,
    )


def spec_first_tokens(params: dict, cfg: LLMConfig, last_hidden, min_len_t, max_len_t,
                      sampling: SamplingParams, gumbel):
    """Each row's first pending token from head 0 on its last prompt hidden,
    the exact heads=1 distribution (llm.py:541-556): last_hidden (B, H),
    min_len_t / max_len_t (B,), gumbel (B, V). A row stops at once on a stop
    id or a budget below 1 (llm.py:548-550). Returns (t0 (B,) int64 on the
    device, stop0 (B,) bool on the device, stop0 as host bools: the one
    host read)."""
    sts = cfg.speech_token_size
    logits = mtp_logits(params, cfg, last_hidden, 1)[0]  # (B, V)
    history = torch.full((1, 1), -1, dtype=torch.int32, device=logits.device)
    q0 = ras_dist_rows(logits, history, 0, sampling, min_len_t > 0, sts)
    t0 = sample_dist(q0, gumbel.to(logits.device))
    stop0 = (t0 >= sts) | (max_len_t < 1)
    return t0, stop0, stop0.tolist()


def set_first_tokens(state: dict, t0, stop0, stop_host, rows: slice = slice(None)):
    """The rows `rows` of a `spec_state` (all of them, or a slot's one) start
    from their first tokens (llm.py:551-562), in place."""
    state["pend_t"][rows] = t0
    state["tokens"][rows, 0] = torch.where(stop0, -1, t0).to(torch.int32)
    state["num_t"][rows] = (~stop0).to(torch.int64)
    state["done_t"][rows] = stop0
    state["num"][rows] = [0 if s else 1 for s in stop_host]
    state["finished"][rows] = list(stop_host)


def _spec_draft_rows(draft_logits, tokens, num_t, sampling: SamplingParams, min_len_t,
                     sts: int, gumbel):
    """Per-row draft sampling with explicit distributions (llm.py:565-577),
    B rows at once. draft_logits (B, kd, V) from heads 1..K-1 on the last
    cached hidden; draft j ignores EOS iff num + j < min_len. Returns
    (drafts (B, kd), p_dists (B, kd, V), buf_d: tokens with the drafts
    tentatively written at [num, num + kd))."""
    kd = draft_logits.shape[1]
    dev = draft_logits.device
    counts = num_t[:, None] + torch.arange(kd, device=dev)
    p_dists = ras_dist_rows(draft_logits, tokens[:, None, :], num_t[:, None], sampling,
                            counts < min_len_t[:, None], sts)
    drafts = sample_dist(p_dists, gumbel)
    buf_d = tokens.scatter(1, counts, drafts.to(tokens.dtype))
    return drafts, p_dists, buf_d


def _spec_verify_rows(tgt_logits, drafts, p_dists, buf_d, num_t, min_len_t, max_len_t,
                      sampling: SamplingParams, sts: int, u, gumbel_res, gumbel_bonus):
    """Speculative accept/reject and emission bookkeeping (llm.py:580-624),
    B rows at once. tgt_logits (B, K, V): head 0 on each in-block hidden;
    u (B, kd) uniforms, gumbel_res / gumbel_bonus (B, V). Returns, on the
    device, (e (B, K) emitted tokens, n_emit, n_commit, n_acc, finished),
    the last four (B,)."""
    b, kd = drafts.shape
    head_k = kd + 1
    dev = drafts.device
    rows = torch.arange(b, device=dev)
    counts = num_t[:, None] + torch.arange(kd, device=dev)
    # the target distributions see the drafts already in the history, each
    # at its own count
    q_dists = ras_dist_rows(tgt_logits[:, :kd], buf_d[:, None, :], counts, sampling,
                            counts < min_len_t[:, None], sts)
    p_d = torch.gather(p_dists, 2, drafts[:, :, None])[:, :, 0]
    q_d = torch.gather(q_dists, 2, drafts[:, :, None])[:, :, 0]
    accept = u * p_d < q_d  # u < q/p without the divide
    n_acc = torch.sum(torch.cumprod(accept.to(torch.int64), dim=1), dim=1)
    all_acc = n_acc == kd

    # the rejected position resamples from the normalised residual max(q-p, 0),
    # or from q where the residual has no mass
    j = torch.clamp(n_acc, max=kd - 1)
    q_j, p_j = q_dists[rows, j], p_dists[rows, j]
    res = torch.clamp_min(q_j - p_j, 0.0)
    z = torch.sum(res, dim=-1, keepdim=True)
    r_tok = sample_dist(torch.where(z > 1e-12, res / z, q_j), gumbel_res)
    # the bonus token when every draft holds: head 0 on the last block hidden
    bonus_num = num_t + kd
    q_bonus = ras_dist_rows(tgt_logits[:, kd], buf_d, bonus_num, sampling,
                            bonus_num < min_len_t, sts)
    b_tok = sample_dist(q_bonus, gumbel_bonus)

    # emitted: the accepted drafts, then r (a rejection) or the bonus
    e = torch.cat([drafts, b_tok[:, None]], dim=1)
    e[rows, j + all_acc.to(torch.int64)] = torch.where(all_acc, b_tok, r_tok)
    n_emit = torch.where(all_acc, head_k, n_acc + 1)

    # stop and budget, as generate_until's
    arange_k = torch.arange(head_k, device=dev)
    valid = arange_k[None, :] < n_emit[:, None]
    stop_seen = (e >= sts) & valid
    before_stop = torch.cumsum(stop_seen.to(torch.int64), dim=1) == 0
    n_ok = torch.sum(before_stop & valid, dim=1)
    budget = torch.clamp_min(max_len_t - num_t, 0)
    n_commit = torch.minimum(n_ok, budget)
    finished = torch.any(stop_seen, dim=1) | (num_t + n_commit >= max_len_t)
    return e, n_emit, n_commit, n_acc, finished


def spec_step_batched(params: dict, cfg: LLMConfig, state: dict, sampling: SamplingParams,
                      draws, *, head_k: int):
    """One draft-and-verify step over the B rows of `state` (see
    `spec_state`): the body of the solo loop, the flash batch's and a spec
    slots' chunk (llm.py:657-705, :780-839, continuous.py:699-770). Updated
    in place. draws: (draft Gumbels (B, kd, V), accept uniforms (B, kd),
    residual and bonus Gumbels (B, V)).

    The draft heads run once over all rows (M = B each); one backbone
    forward writes the (B, K) block [pend, drafts] at each row's cache
    length and commits nothing; head 0 runs on the (B, K, H) block
    (M = B x K). A row that was finished at the step's start emits nothing
    and keeps its pend and last_hidden (llm.py:817-839). The cache keeps
    [pend, accepted drafts], n_emit rows, of a row that goes on; the rejected
    drafts' rows stay written past its length and the next block overwrites
    them before any query can see them. A row that finishes in this step
    keeps no row either, since its cache is never read again, so a block
    write stays inside the cache of `cache_len_cap` for any row. One host
    read per step: (n_emit, n_commit, n_acc, finished) of every row."""
    sts = cfg.speech_token_size
    kd = head_k - 1
    g_draft, u, g_res, g_bonus = draws
    cache, tokens, num_t = state["cache"], state["tokens"], state["num_t"]
    s_max = cache.k.shape[2]
    if max(state["cache_pos"]) + head_k > s_max:
        raise ValueError(f"decode block at {max(state['cache_pos'])} overruns the cache "
                         f"of {s_max}")
    b = tokens.shape[0]
    dev = tokens.device

    draft_logits = mtp_logits(params, cfg, state["last_hidden"], kd, first=1).transpose(0, 1)
    drafts, p_dists, buf_d = _spec_draft_rows(draft_logits, tokens, num_t, sampling,
                                              state["min_len_t"], sts, g_draft.to(dev))
    block = torch.cat([state["pend_t"][:, None], drafts], dim=1)  # (B, K)
    hidden, _ = qwen2.forward_block_with_cache(
        params["backbone"], cfg.backbone, params["speech_embedding"][block], cache,
        advance=torch.zeros(b, dtype=torch.int32, device=dev), decode_step=True)
    tgt_logits = mtp_logits(params, cfg, hidden, 1)[0]  # (B, K, V)
    e, n_emit, n_commit, n_acc, fin = _spec_verify_rows(
        tgt_logits, drafts, p_dists, buf_d, num_t, state["min_len_t"], state["max_len_t"],
        sampling, sts, u.to(dev), g_res.to(dev), g_bonus.to(dev))

    active = ~state["done_t"]
    n_emit = torch.where(active, n_emit, 0)
    n_commit = torch.where(active, n_commit, 0)
    done = state["done_t"] | (active & fin)
    arange_k = torch.arange(head_k, device=dev)
    wpos = num_t[:, None] + arange_k
    wmask = arange_k[None, :] < n_commit[:, None]
    tokens.scatter_(1, wpos, torch.where(wmask, e.to(tokens.dtype), torch.gather(tokens, 1, wpos)))
    kept = torch.where(done, 0, n_emit)
    idx_last = torch.clamp_min(n_emit - 1, 0)
    rows = torch.arange(b, device=dev)
    state["cache"] = qwen2.KVCache(k=cache.k, v=cache.v,
                                   length=(cache.length + kept).to(torch.int32))
    state["last_hidden"] = torch.where(active[:, None], hidden[rows, idx_last],
                                       state["last_hidden"])
    state["pend_t"] = torch.where(active, e[rows, idx_last], state["pend_t"])
    state["num_t"] = num_t + n_commit
    state["done_t"] = done
    for r, (n_c, n_a, d, k_r) in enumerate(
            torch.stack([n_commit, n_acc, done.to(torch.int64), kept], dim=1).tolist()):
        if not state["finished"][r]:  # the step's one host read, above
            state["num"][r] += n_c
            state["accepted"][r] += n_a
            state["drafted"][r] += kd
            state["cache_pos"][r] += k_r
        state["finished"][r] = bool(d)
    state["steps"] += 1


def init_spec_state(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len: int,
                    min_len: int, max_len: int, sampling: SamplingParams, noise, *,
                    num_heads: int, max_tokens: int = 1024,
                    cache_len_cap: Optional[int] = None) -> dict:
    """Prefill and the first pending token (llm.py:507-562): the spec
    counterpart of `init_generate_state`, resumable by `generate_spec_until`
    (streams pause at chunk targets). The first token comes from head 0 on
    the prompt hidden, the exact heads=1 distribution, on
    `noise.spec_first(vocab)`. A one-row `spec_state`."""
    head_k = _spec_head_k(num_heads, cfg)
    hidden, cache = _prefill(params, cfg, prompt_embeds[None], [prompt_len],
                             max_tokens=max_tokens, head_k=head_k, cache_len_cap=cache_len_cap)
    state = spec_state(cache, hidden[:, int(prompt_len) - 1], [prompt_len], [min_len],
                       [max_len], max_tokens=max_tokens, head_k=head_k)
    set_first_tokens(state, *spec_first_tokens(
        params, cfg, state["last_hidden"], state["min_len_t"], state["max_len_t"], sampling,
        noise.spec_first(cfg.vocab_size)[None]))
    return state


def generate_spec_until(params: dict, cfg: LLMConfig, state: dict, target_num: int,
                        sampling: SamplingParams, noise, *, num_heads: int) -> dict:
    """Draft-and-verify steps (llm.py:627-705) on the one-row state of
    `init_spec_state` until `target_num` tokens exist or generation
    finishes; the state's own min_len and max_len bound it. Each step draws
    `noise.spec_step(K - 1, vocab)`, so pausing at a target changes no draw
    and chunked output equals one-shot output."""
    head_k = _spec_head_k(num_heads, cfg)
    while not state["finished"][0] and state["num"][0] < target_num:
        draws = noise.spec_step(head_k - 1, cfg.vocab_size)
        spec_step_batched(params, cfg, state, sampling, tuple(d[None] for d in draws),
                          head_k=head_k)
    return state


def generate_speculative(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len: int,
                         min_len: int, max_len: int, sampling: SamplingParams, noise, *,
                         num_heads: int, max_tokens: int = 1024,
                         cache_len_cap: Optional[int] = None) -> SpecResult:
    """Self-speculative MTP decode of one utterance (llm.py:861-914): heads
    1..K-1 draft, head 0 verifies, K = max(2, min(num_heads, head_num)).
    The emitted sequence has the exact heads=1 RAS distribution; under
    deterministic sampling (top_k 1, tau_r > 1) it is heads=1's token for
    token, whatever the drafts' quality. Each block forward commits 1 to K
    tokens."""
    state = init_spec_state(params, cfg, prompt_embeds, prompt_len, min_len, max_len, sampling,
                            noise, num_heads=num_heads, max_tokens=max_tokens,
                            cache_len_cap=cache_len_cap)
    state = generate_spec_until(params, cfg, state, max_len, sampling, noise,
                                num_heads=num_heads)
    return SpecResult(
        result=GenerateResult(tokens=state["tokens"][0, :max_tokens],
                              num_tokens=state["num"][0], steps=state["steps"]),
        accepted=state["accepted"][0], drafted=state["drafted"][0])


def generate_batched_speculative(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len,
                                 min_len, max_len, sampling: SamplingParams, noise, *,
                                 num_heads: int, max_tokens: int = 1024,
                                 cache_len_cap: Optional[int] = None) -> SpecResult:
    """The flash batch's speculative decode (llm.py:708-858): every row
    drafts and verifies on its own, sharing each weight read; rows commit 1
    to K tokens a step and drift apart in length, which the per-row cache
    lengths absorb. prompt_embeds (B, T, H) padded; prompt_len, min_len,
    max_len: B ints. `noise.spec_first_batch(b, vocab)` gives the first
    tokens' draws and `noise.spec_step_batch(b, K - 1, vocab)` each step's.
    Returns tokens (B, max_tokens), num_tokens (B ints), steps, and accepted
    and drafted summed over the rows."""
    head_k = _spec_head_k(num_heads, cfg)
    b = prompt_embeds.shape[0]
    dev = prompt_embeds.device
    prompt_len = [int(n) for n in prompt_len]
    hidden, cache = _prefill(params, cfg, prompt_embeds, prompt_len, max_tokens=max_tokens,
                             head_k=head_k, cache_len_cap=cache_len_cap)
    last = hidden[torch.arange(b, device=dev), torch.tensor(prompt_len, device=dev) - 1]
    state = spec_state(cache, last, prompt_len, min_len, max_len, max_tokens=max_tokens,
                       head_k=head_k)
    set_first_tokens(state, *spec_first_tokens(
        params, cfg, last, state["min_len_t"], state["max_len_t"], sampling,
        noise.spec_first_batch(b, cfg.vocab_size)))
    while not all(state["finished"]):
        spec_step_batched(params, cfg, state, sampling,
                          noise.spec_step_batch(b, head_k - 1, cfg.vocab_size), head_k=head_k)
    return SpecResult(
        result=GenerateResult(tokens=state["tokens"][:, :max_tokens], num_tokens=state["num"],
                              steps=state["steps"]),
        accepted=sum(state["accepted"]), drafted=sum(state["drafted"]))
