"""How far weight-only int8 moves the LLM's decode from the dense weights
(port of flowmirror_hydravox_tpu/tools/eval_int8.py).

    python -m flowmirror_hydravox_tpu_torch.tools.eval_int8 [--utterances 6] \
        [--tokens 125] [--text_len 63] [--tiny] [--device cuda|cpu]

int8 mode (ops/quant.py, `Engine(quantize="int8")`) quantizes the LLM only,
so audio differences are token differences. On the same seeded weights (the
launcher's seed-0 init: bf16 at full width, f32 with --tiny) and the same
seeded texts, two measurements:

  1. greedy token agreement: each utterance decodes `--tokens` tokens (the
     stop ids ignored) with greedy sampling (top_k 1, tau_r 10, so the
     repetition fallback never fires) at four heads (or the config's
     fewer), dense and int8: the exact-sequence matches, the token-level
     agreement and the median first divergence of the utterances that
     differ (each one's in `first_divergence_each`);
  2. next-token drift: on the dense greedy prefixes (none, and half of each
     of the first three utterances), the softmax of heads 0-3 with each
     tree: KL(dense || int8), its mean and max over probes and heads, and
     top-1 agreement over all of them (and per head beside them).

The flags and the JSON fields are JAX's (`--tiny` clamps the tokens to 32
and the text to 16, as there); `--device` stands in for JAX's `--cpu`.
Runs on the card unless `--device cpu`. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import llm as llm_model
from ..noise import TorchNoise
from ..ops.quant import quantize_llm_params
from ..ops.sampling import SamplingParams

GREEDY = SamplingParams.make(top_p=1.0, top_k=1, win_size=10, tau_r=10.0)
HEADS = 4


def _prompt(params, cfg, text, prefix, device):
    return llm_model.build_inference_prompt(
        params, cfg, torch.as_tensor(text, dtype=torch.int32, device=device), len(text),
        torch.as_tensor(prefix, dtype=torch.int32, device=device), len(prefix))


@torch.inference_mode()
def _greedy(params, cfg, text, n_tok, heads, device):
    emb, plen = _prompt(params, cfg, text, np.zeros(0, np.int32), device)
    noise = TorchNoise(torch.Generator(device=device).manual_seed(0))  # greedy: unused draws
    res = llm_model.generate(params, cfg, emb, plen, n_tok, n_tok, GREEDY, noise,
                             inference_head_num=heads, max_tokens=n_tok)
    return np.asarray(res.tokens[:res.num_tokens].cpu())


@torch.inference_mode()
def _head_dists(params, cfg, text, prefix, heads, device):
    """Softmax of heads 0..heads-1 after `text` and the speech `prefix`,
    (heads, V) float64."""
    emb, plen = _prompt(params, cfg, text, prefix, device)
    state = llm_model.init_generate_state(params, cfg, emb, plen, inference_head_num=heads,
                                          max_tokens=1)
    logits = llm_model.mtp_logits(params, cfg, state["last_hidden"], heads)
    return torch.softmax(logits.double(), dim=-1).cpu().numpy()


def evaluate(cfg, dense, int8=None, *, utterances: int = 6, tokens: int = 125,
             text_len: int = 63, device="cuda") -> dict:
    """The two measurements (module docstring) on the LLM tree `dense` and
    its int8 form (`int8`, default quantized here)."""
    int8 = quantize_llm_params(dense) if int8 is None else int8
    heads = min(HEADS, cfg.head_num)
    rng = np.random.default_rng(0)
    texts = [rng.integers(0, 1000, (text_len,)).astype(np.int32) for _ in range(utterances)]
    seqs = {name: [_greedy(p, cfg, t, tokens, heads, device) for t in texts]
            for name, p in (("dense", dense), ("int8", int8))}
    same = agree = total = 0
    first_div = []
    for a, b in zip(seqs["dense"], seqs["int8"]):
        n = min(len(a), len(b))
        eq = a[:n] == b[:n]
        agree += int(eq.sum())
        total += max(len(a), len(b))
        if len(a) == len(b) and eq.all():
            same += 1
        else:
            first_div.append(int(np.argmin(eq)) if not eq.all() else n)

    kls, top1 = [], []
    for text, seq in list(zip(texts, seqs["dense"]))[:3]:
        for cut in (0, len(seq) // 2):
            d_dense, d_int8 = (_head_dists(p, cfg, text, seq[:cut], heads, device)
                               for p in (dense, int8))
            kls.append(np.sum(d_dense * (np.log(d_dense + 1e-12) - np.log(d_int8 + 1e-12)),
                              axis=-1))
            top1.append(d_dense.argmax(-1) == d_int8.argmax(-1))
    kls, top1 = np.stack(kls), np.stack(top1)  # (probes, heads)
    return dict(
        metric="int8_quality_delta",
        device=str(device), utterances=utterances, tokens=tokens, text_len=text_len,
        heads=heads,
        greedy_seq_match=f"{same}/{utterances}",
        greedy_token_agreement=round(agree / max(total, 1), 4),
        first_divergence_tokens=int(np.median(first_div)) if first_div else None,
        kl_bf16_int8_mean=round(float(kls.mean()), 6),
        kl_bf16_int8_max=round(float(kls.max()), 6),
        top1_agreement=round(float(top1.mean()), 4),
        first_divergence_each=first_div,
        kl_dense_int8_per_head=kls.mean(axis=0).tolist(),
        top1_agreement_per_head=top1.mean(axis=0).tolist(),
        probes=len(kls),
        note="weight-only int8 LLM against the dense tree, flow and HiFT unquantized; greedy "
             "sampling isolates the token stream, so audio deltas are token deltas",
    )


def main(argv=None):
    p = argparse.ArgumentParser("eval_int8")
    p.add_argument("--utterances", type=int, default=6)
    p.add_argument("--tokens", type=int, default=125)
    p.add_argument("--text_len", type=int, default=63)
    p.add_argument("--tiny", action="store_true", help="tiny config, f32 weights")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from .. import __main__ as launcher
    from ..device import resolve_device
    from ..frontend.tokenizer import get_tokenizer

    device = resolve_device(args.device)
    cfg, trees = launcher.load_models(args.tiny, None, get_tokenizer(None), device,
                                      torch.float32 if args.tiny else torch.bfloat16)
    tokens = min(args.tokens, 32) if args.tiny else args.tokens
    text_len = min(args.text_len, 16) if args.tiny else args.text_len
    out = evaluate(cfg.llm, trees["llm"], utterances=args.utterances, tokens=tokens,
                   text_len=text_len, device=device)
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
