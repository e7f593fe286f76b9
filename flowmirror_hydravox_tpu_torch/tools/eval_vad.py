"""VAD quality: the trained native model against the energy baseline (port
of flowmirror_hydravox_tpu/tools/eval_vad.py).

Held-out synthetic speech + noise clips with exact activity ground truth
(train/synth_speech.py); frame-level precision, recall and F1 per noise
condition for

  - energy: the adaptive-threshold RMS VAD (preprocess/vad.py's fallback);
  - native: the trained dilated-conv model (preprocess/vad_model.py), on
    `--device` (default cuda; `--cpu` for the host).

  python -m flowmirror_hydravox_tpu_torch.tools.eval_vad [--clips 20] [--snr 5]

Prints a table and one JSON line. Babble and hum are where the energy VAD
fails by construction (noise energy ~ speech energy) and the trained model
is expected to hold its F1.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

SR = 16000
HOP = 160


def frame_truth(mask: np.ndarray, n_frames: int) -> np.ndarray:
    f = min(len(mask) // HOP, n_frames)
    return mask[: f * HOP].reshape(f, HOP).max(axis=1)


def segments_to_frames(segs, n_frames: int) -> np.ndarray:
    out = np.zeros(n_frames, np.uint8)
    for s, e in segs:
        out[int(s / 0.010): int(e / 0.010) + 1] = 1
    return out[:n_frames]


def prf(pred: np.ndarray, truth: np.ndarray):
    f = min(len(pred), len(truth))
    pred, truth = pred[:f] > 0, truth[:f] > 0
    tp = int((pred & truth).sum())
    fp = int((pred & ~truth).sum())
    fn = int((~pred & truth).sum())
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    f1 = 2 * p * r / max(p + r, 1e-9)
    return p, r, f1


def evaluate(n_clips: int = 20, snr_db: float = 5.0, seconds: float = 6.0,
             seed: int = 7, device="cuda"):
    """{condition: {detector: (precision, recall, F1)}}, the means over
    `n_clips` clips; `native` is missing when no VAD weights exist."""
    from ..preprocess.vad import VADConfig, detect_speech
    from ..preprocess.vad_model import maybe_native_vad
    from ..train.synth_speech import synth_noise, synth_utterance_with_mask

    native = maybe_native_vad(device=device)
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    # post-rules off (min_dur/min_gap tiny): measure the detector itself
    cfg = VADConfig(min_gap_s=0.12, min_dur_s=0.1)
    conditions = ["clean", "white", "pink", "hum", "babble"]
    results = {}
    for cond in conditions:
        scores = {"energy": [], "native": []}
        for c in range(n_clips):
            speech, mask = synth_utterance_with_mask(
                int(rng.integers(1 << 16)), 5_000_000 + c, seconds, seed=3)
            wav = speech[:n].copy()
            if cond != "clean":
                noise = synth_noise(cond, n, rng)
                sp = np.sqrt(np.mean(wav ** 2) + 1e-9)
                npow = np.sqrt(np.mean(noise ** 2) + 1e-9)
                wav = wav + noise * (sp / npow) * (10 ** (-snr_db / 20.0))
            truth = frame_truth(mask[:n], n // HOP)
            segs_e = detect_speech(wav, SR, cfg)
            scores["energy"].append(prf(segments_to_frames(segs_e, len(truth)), truth))
            if native is not None:
                segs_n = detect_speech(wav, SR, cfg, speech_prob_fn=native)
                scores["native"].append(prf(segments_to_frames(segs_n, len(truth)), truth))
        results[cond] = {
            det: tuple(float(np.mean([s[i] for s in sc])) for i in range(3))
            for det, sc in scores.items() if sc
        }
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--clips", type=int, default=20)
    p.add_argument("--snr", type=float, default=5.0)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    results = evaluate(args.clips, args.snr, args.seconds,
                       device="cpu" if args.cpu else args.device)
    print(f"{'condition':<10} {'detector':<8} {'P':>6} {'R':>6} {'F1':>6}")
    for cond, dets in results.items():
        for det, (pp, rr, f1) in dets.items():
            print(f"{cond:<10} {det:<8} {pp:6.3f} {rr:6.3f} {f1:6.3f}")
    summary = {
        f"{cond}_{det}_f1": round(v[2], 4)
        for cond, dets in results.items() for det, v in dets.items()
    }
    print(json.dumps({"metric": "vad_f1", "snr_db": args.snr, **summary}))


if __name__ == "__main__":
    main()
