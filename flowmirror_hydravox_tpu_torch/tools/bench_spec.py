"""Speculative-decode speedup: spec (heads K draft + verify) against
sequential heads 1 on the serving config: port of
flowmirror_hydravox_tpu/tools/bench_spec.py.

    python -m flowmirror_hydravox_tpu_torch.tools.bench_spec [--heads 4] [--reps 4] \
        [--trained [--ckpt PATH] | --trained --train_on_chip] [--device cuda|cpu] [--tiny]

Both modes produce the exact heads=1 output distribution (models/llm.py
`generate_speculative`), so this measures the throughput effect of MTP
draft acceptance alone. Every run decodes exactly `--tokens` tokens of a
`--text_len` text (min = max token ratio), so tokens/s compare like for
like. Prints one JSON line per rep (untrained), then a summary line
`{"spec_best_tps", "heads1_best_tps", "speedup", "acceptance",
"tokens_per_step"}`; with `--trained` the summary is JAX's
`spec_decode_trained_heads{K}` line.

Random-weight MTP heads draft near chance, so the untrained acceptance is a
lower bound. `--trained` loads the readout that tools/train_spec_ckpt.py
trains over the same seed-0 tree (`--ckpt`, default its `--out`); it must
have been trained over this tree (`load_spec_readout` refuses another).
`--trained --train_on_chip` instead trains the whole LLM in-process for
`--train_steps` steps of `llm_train_step` on a cyclic corpus (JAX :100-131).
The weights are the launcher's seed-0 draw on `--device` (default cuda);
torch seeds stand in for the JAX keys.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np


def train_in_process(cfg, params, steps: int, tiny: bool, device):
    """JAX :100-131: `llm_train_step` at a constant lr on cyclic-successor
    rows over the whole speech vocab. Returns (params, the last acc)."""
    from ..train.steps import OptimConfig, Optimizer, batch_to, init_state, llm_train_step

    sts = cfg.speech_token_size
    b, lt, ls = 8, 8, 64
    n = max(steps, 20)
    opt = Optimizer(OptimConfig(learning_rate=3e-3 if tiny else 3e-4, warmup_steps=10,
                                total_steps=n, schedule="constant"))
    state = init_state(params, opt)
    rng = np.random.default_rng(0)
    metrics = None
    for _ in range(n):
        starts = rng.integers(0, sts, (b, 1))
        batch = {"text_token": rng.integers(0, 1000, (b, lt)).astype(np.int32),
                 "text_len": np.full((b,), lt, np.int32),
                 "speech_token": ((starts + np.arange(ls)[None, :]) % sts).astype(np.int32),
                 "speech_len": np.full((b,), ls, np.int32)}
        state, metrics = llm_train_step(state, batch_to(batch, device), cfg, opt)
    return state.params, float(metrics["acc"])


def spec_engine(cfg, trees, n_tokens: int, device):
    """An engine with --spec-decode (heads >= 2 speculate, heads 1 decodes
    blind) on `trees`, its decode cache sized for `n_tokens`."""
    from ..runtime.engine import Engine

    return Engine(cfg, trees["llm"], trees["flow"], trees["hift"],
                  max_tokens=-(-n_tokens // 64) * 64, device=device, fused=False,
                  spec_decode=True)


def bench(eng, heads: int, reps: int, n_tokens: int, text_len: int, verbose: bool, log=print):
    """One warm-up then `reps` seeded decodes at `heads` of a `text_len`
    text into exactly `n_tokens` tokens. Returns the best result by
    tokens/s."""
    text = np.arange(text_len, dtype=np.int32) % 1000
    mode = f"spec{heads}" if eng.speculates(heads) else "heads1"

    def run(seed):
        return eng.synthesize(text_tokens=text, tts_text_len=text_len, inference_head_num=heads,
                              min_token_text_ratio=n_tokens / text_len,
                              max_token_text_ratio=n_tokens / text_len, noise=eng.noise_for(seed))

    t0 = time.time()
    run(42)
    log(f"# {mode} warm-up {time.time() - t0:.1f}s")
    best = None
    for i in range(reps):
        r = run(100 + i)
        if verbose:
            line = dict(mode=mode, tps=round(r.tps, 1), steps=r.steps,
                        toks=len(r.speech_tokens), llm_s=round(r.llm_time, 4))
            if eng.speculates(heads):
                line["acc"] = round(r.spec_acceptance, 3)
            log(json.dumps(line))
        if best is None or r.tps > best.tps:
            best = r
    return best


def summarize(best, heads1) -> dict:
    """The summary line of the best spec run against the best heads-1 run."""
    return dict(spec_best_tps=round(best.tps, 1), heads1_best_tps=round(heads1.tps, 1),
                speedup=round(best.tps / heads1.tps, 2),
                acceptance=round(best.spec_acceptance, 3),
                tokens_per_step=round(len(best.speech_tokens) / max(best.steps, 1), 2))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--tokens", type=int, default=125, help="generated tokens per run")
    p.add_argument("--text_len", type=int, default=63)
    p.add_argument("--tiny", action="store_true", help="tiny config (CPU smoke)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--trained", action="store_true",
                   help="load the trained readout (tools/train_spec_ckpt.py) and measure the "
                        "design point")
    p.add_argument("--ckpt", default=None, help="the readout npz (default: train_spec_ckpt's "
                                                "--out)")
    p.add_argument("--train_on_chip", action="store_true",
                   help="with --trained: train the whole LLM in-process instead (slow)")
    p.add_argument("--train_steps", type=int, default=150)
    args = p.parse_args(argv)

    from ..device import resolve_device
    from .train_spec_ckpt import DEFAULT_OUT, load_spec_readout, load_tree

    device = resolve_device(args.device)
    cfg, trees, tree = load_tree(args.tiny, device)
    train_acc = ckpt_meta = None
    if args.trained and not args.train_on_chip:
        path = args.ckpt or DEFAULT_OUT
        trees["llm"], ckpt_meta = load_spec_readout(trees["llm"], path, tree)
        train_acc = float(ckpt_meta.get("train_acc", -1.0))
        print(f"# loaded trained readout {path} (train_acc {train_acc:.3f})", flush=True)
    elif args.trained:
        t0 = time.time()
        trees["llm"], train_acc = train_in_process(cfg.llm, trees["llm"], args.train_steps,
                                                   args.tiny, device)
        print(f"# trained {args.train_steps} steps in {time.time() - t0:.1f}s "
              f"(multi-head CE acc {train_acc:.3f})", flush=True)

    n_tokens = min(args.tokens, 48) if args.tiny else args.tokens
    text_len = min(args.text_len, 24) if args.tiny else args.text_len
    eng = spec_engine(cfg, trees, n_tokens, device)
    log = functools.partial(print, flush=True)
    best = bench(eng, args.heads, args.reps, n_tokens, text_len, not args.trained, log)
    heads1 = bench(eng, 1, args.reps, n_tokens, text_len, not args.trained, log)
    summary = summarize(best, heads1)
    if args.trained:
        summary = dict(
            metric=f"spec_decode_trained_heads{args.heads}", value=summary["spec_best_tps"],
            unit="tok/s", acceptance=summary["acceptance"],
            tokens_per_step=summary["tokens_per_step"], heads1_tps=summary["heads1_best_tps"],
            speedup=summary["speedup"], train_acc=round(train_acc or 0.0, 3),
            ckpt=("in-process" if args.train_on_chip else
                  (ckpt_meta or {}).get("recipe", "")[:60]),
            note="exact heads=1 distribution; trained readout on a cyclic-successor corpus "
                 "(tools/train_spec_ckpt.py)")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
