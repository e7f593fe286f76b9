"""Multi-head (MTP) speech-token LM inference: the subset of
flowmirror_hydravox_tpu/models/llm.py on the SFT path.

  - MTP heads in the reduced length-1 form (`_mtp_head_apply`): a Qwen2
    decoder layer applied to one position reduces to
        h = x + o_proj(v_proj(rms_1(x)));  y = h + mlp(rms_2(h)).
  - KV-cached group decode: each step samples K = inference_head_num tokens
    against the same history, accepts them up to the first stop id, and runs
    one backbone forward over the K accepted tokens.
  - The flash batch (`generate_batched`): B utterances decode together with
    per-row lengths and stops, sharing each weight read; its step,
    `decode_step_batched`, is also the continuous batcher's.

Every decode-step MLP (the MTP heads' and the backbone's) goes through
`ops.mlp_gemv.mlp_gemv`, the fused SwiGLU GEMV kernel on the card; the
prompt prefill's MLP stays torch.matmul.

The decode loops are Python loops with one host read per step (the sampled
ids): it decides how many tokens to accept and whether to stop, as the JAX
`lax.while_loop` body does on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import LLMConfig
from ..ops.mlp_gemv import mlp_gemv
from ..ops.sampling import SamplingParams, ras_sample_heads, ras_sample_heads_batched
from . import qwen2

CACHE_ROUND = 256  # cache lengths round up to a multiple of this


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (max_tokens,) int32 on the device, valid prefix only;
    # (B, max_tokens) from generate_batched
    num_tokens: int  # a list of B ints from generate_batched
    steps: int  # base-LLM step count (for TPS metrics)


def _mtp_head_apply(head: dict, x, eps: float):
    """Single head, pointwise. x: (..., H) -> (..., H)."""
    attn_in = qwen2._rms_norm(x, head["input_layernorm"], eps)
    v = attn_in @ head["v_proj_w"] + head["v_proj_b"]
    x = x + v @ head["o_proj_w"]
    mlp_in = qwen2._rms_norm(x, head["post_attention_layernorm"], eps)
    return x + mlp_gemv(mlp_in, head["gate_proj_w"], head["up_proj_w"], head["down_proj_w"])


def mtp_logits(params: dict, cfg: LLMConfig, hidden, num_heads: int):
    """Heads 0..num_heads-1 and the shared decoder: (..., H) -> (num_heads, ..., V) f32."""
    eps = cfg.backbone.rms_norm_eps
    outs = [
        _mtp_head_apply({k: v[i] for k, v in params["mtp_block"].items()}, hidden, eps)
        for i in range(num_heads)
    ]
    return (torch.stack(outs) @ params["llm_decoder"]).to(torch.float32)


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


def init_generate_state(params: dict, cfg: LLMConfig, prompt_embeds, prompt_len: int, *,
                        inference_head_num: int, max_tokens: int = 1024,
                        cache_len_cap: Optional[int] = None) -> dict:
    """Prefill the KV cache and build the decode-loop state."""
    head_k = max(1, min(int(inference_head_num), cfg.head_num))
    t_prompt = prompt_embeds.shape[0]
    if cache_len_cap is None:
        cache_len_cap = t_prompt + max_tokens + head_k
    cap = -(-cache_len_cap // CACHE_ROUND) * CACHE_ROUND
    if t_prompt > cap:  # jax.lax.dynamic_update_slice would clamp the write
        raise ValueError(f"prompt block of {t_prompt} exceeds the cache of {cap}")
    dev = prompt_embeds.device
    cache = qwen2.init_kv_cache(cfg.backbone, 1, cap, dtype=prompt_embeds.dtype, device=dev)
    hidden, cache = qwen2.forward_block_with_cache(
        params["backbone"], cfg.backbone, prompt_embeds[None], cache,
        advance=torch.tensor([prompt_len], dtype=torch.int32, device=dev),
    )
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
    b, t_prompt, _ = prompt_embeds.shape
    if cache_len_cap is None:
        cache_len_cap = t_prompt + max_tokens + head_k
    cap = -(-cache_len_cap // CACHE_ROUND) * CACHE_ROUND
    if t_prompt > cap:
        raise ValueError(f"prompt block of {t_prompt} exceeds the cache of {cap}")
    bb = cfg.backbone
    dev = prompt_embeds.device
    prompt_len = [int(n) for n in prompt_len]

    cache = qwen2.init_kv_cache(bb, b, cap, dtype=prompt_embeds.dtype, device=dev)
    hidden, cache = qwen2.forward_block_with_cache(
        params["backbone"], bb, prompt_embeds, cache,
        advance=torch.tensor(prompt_len, dtype=torch.int32, device=dev),
    )
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
