"""ASR quality of the shipped native CTC recognizer (port of
flowmirror_hydravox_tpu/tools/eval_asr.py).

Token error rate (Levenshtein / reference length) of the trained checkpoint
(preprocess/assets/asr.npz) on held-out synthetic utterances: speakers 300+
and utterance ids 10000+, outside the training pool (speakers 0-255,
utterances 0-767), clean and at `--snr` per noise condition. The model runs
on `--device` (default cuda).

  python -m flowmirror_hydravox_tpu_torch.tools.eval_asr [--clips 24] [--snr 10]

Prints one JSON line and a table.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

SR = 16000


def evaluate(n_clips: int = 24, snr_db: float = 10.0, seconds: float = 4.0,
             seed: int = 11, ckpt: str = None, device="cuda"):
    """{condition: mean TER} over `n_clips` held-out clips."""
    from ..preprocess.asr_model import NativeASR, token_error_rate
    from ..train.synth_speech import synth_noise, synth_utterance_with_segments

    asr = NativeASR(ckpt, device=device)
    rng = np.random.default_rng(seed)
    conditions = ["clean", "white", "pink", "hum", "babble"]
    results = {}
    for cond in conditions:
        ters = []
        for c in range(n_clips):
            spk = 300 + c          # speakers never seen in training
            utt = 10_000 + c       # utterance ids beyond the training pool
            wav, segs = synth_utterance_with_segments(spk, utt, seconds, seed=1)
            if not segs:
                continue
            if cond != "clean":
                noise = synth_noise(cond, len(wav), rng)
                sp = np.sqrt(np.mean(wav ** 2) + 1e-9)
                npow = np.sqrt(np.mean(noise ** 2) + 1e-9)
                wav = wav + noise * (sp / npow) * (10.0 ** (-snr_db / 20.0))
            hyp = list(asr(wav, SR))
            ters.append(token_error_rate(segs, hyp))
        results[cond] = float(np.mean(ters))
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--clips", type=int, default=24)
    p.add_argument("--snr", type=float, default=10.0)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    results = evaluate(args.clips, args.snr, args.seconds, ckpt=args.ckpt, device=args.device)
    print(json.dumps({"metric": "asr_token_error_rate", "snr_db": args.snr, **results}))
    print(f"{'condition':<10} TER")
    for cond, ter in results.items():
        print(f"{cond:<10} {ter:.3f}")


if __name__ == "__main__":
    main()
