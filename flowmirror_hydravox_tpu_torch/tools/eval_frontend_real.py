"""Evaluation of the frontend extractors on recorded speech: port of
flowmirror_hydravox_tpu/tools/eval_frontend_real.py.

What the zero-shot pipeline needs from the speech tokenizer and the speaker
encoder (reference role cli/frontend.py:92-116), on a directory of
per-speaker recordings:

  - speaker separation: each recording cut into short segments, every
    segment embedded, within-speaker against between-speaker cosine
    similarity, and the share of between-speaker pairs above the
    within-speaker median (an EER-style overlap number);
  - token content-tracking: tokens are deterministic per input, differ
    across segments, and use a diverse code set.

The default corpus is the JAX tool's (`HYDRAVOX_REAL_SPEECH_DIR`, else
/root/reference/assets/samples: five human speakers, 16 kHz, outside this
repository). `--samples_dir` points at any tree of per-speaker wavs
(speaker = the parent directory's name, or the file stem when flat).

  python -m flowmirror_hydravox_tpu_torch.tools.eval_frontend_real \\
      [--samples_dir D] [--device cuda|cpu]

The extractors are the Frontend's (the committed checkpoints, or
HYDRAVOX_TOKENIZER_NPZ / HYDRAVOX_SPEAKER_NPZ) on `--device` (default
cuda; it raises without a GPU). Prints one JSON line, then a table.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import wave

import numpy as np

DEFAULT_SAMPLES = os.environ.get(
    "HYDRAVOX_REAL_SPEECH_DIR", "/root/reference/assets/samples")


# Copied from flowmirror_hydravox_tpu/tools/eval_frontend_real.py (numpy).
def load_segments(samples_dir: str, seg_sec: float = 1.5, hop_sec: float = 0.75):
    """-> {speaker: [float32 wav segment]}, sample_rate. Speaker identity is
    the innermost directory name (falls back to the file stem)."""
    segs = {}
    sr_out = None
    for f in sorted(glob.glob(os.path.join(samples_dir, "**", "*.wav"),
                              recursive=True)):
        parent = os.path.basename(os.path.dirname(f))
        spk = parent if parent and parent != os.path.basename(
            samples_dir.rstrip("/")) else os.path.splitext(os.path.basename(f))[0]
        with wave.open(f) as w:
            sr = w.getframerate()
            if w.getsampwidth() != 2:
                continue
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            if w.getnchannels() > 1:
                pcm = pcm.reshape(-1, w.getnchannels()).mean(axis=1)
        wav = pcm.astype(np.float32) / 32768.0
        n, hop = int(seg_sec * sr), int(hop_sec * sr)
        pieces = [wav[i:i + n] for i in range(0, len(wav) - n + 1, hop)]
        if pieces:
            segs.setdefault(spk, []).extend(pieces)
            sr_out = sr
    return segs, sr_out


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-8))


def evaluate(samples_dir: str = DEFAULT_SAMPLES, frontend=None, seg_sec: float = 1.5,
             hop_sec: float = 0.75, device="cuda") -> dict:
    """The figures of `frontend` (default: the port's Frontend on `device`)
    on `samples_dir`; raises FileNotFoundError under two speakers."""
    if frontend is None:
        from ..config import tiny_config
        from ..frontend.frontend import Frontend

        frontend = Frontend(tiny_config(), device=device)
    segs, sr = load_segments(samples_dir, seg_sec, hop_sec)
    if len(segs) < 2:
        raise FileNotFoundError(
            f"need >=2 speakers under {samples_dir}, found {sorted(segs)}")

    embs = {s: [np.asarray(frontend.extract_spk_embedding(w, sr)).reshape(-1)
                for w in v] for s, v in segs.items()}
    within = [_cos(a, b) for v in embs.values()
              for a, b in itertools.combinations(v, 2)]
    between = [_cos(a, b) for s1, s2 in itertools.combinations(embs, 2)
               for a in embs[s1] for b in embs[s2]]
    thr = float(np.median(within))

    # token content metrics on the speaker with the most material
    spk0 = max(segs, key=lambda s: len(segs[s]))
    t0a = np.asarray(frontend.extract_speech_tokens(segs[spk0][0], sr)).reshape(-1)
    t0b = np.asarray(frontend.extract_speech_tokens(segs[spk0][0], sr)).reshape(-1)
    t1 = np.asarray(frontend.extract_speech_tokens(segs[spk0][1], sr)).reshape(-1)
    m = min(len(t0a), len(t1))

    return {
        "metric": "frontend_real_speech",
        "samples_dir": samples_dir,
        "speakers": len(segs),
        "segments": int(sum(len(v) for v in segs.values())),
        "within_cos_mean": round(float(np.mean(within)), 3),
        "between_cos_mean": round(float(np.mean(between)), 3),
        "separation_gap": round(float(np.mean(within) - np.mean(between)), 3),
        "between_above_within_median": round(
            float(np.mean([b > thr for b in between])), 3),
        "token_deterministic": bool(np.array_equal(t0a, t0b)),
        "token_content_diff_frac": round(float(np.mean(t0a[:m] != t1[:m])), 3),
        "token_unique_codes": int(len(set(t0a.tolist()))),
        "token_len": int(len(t0a)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--samples_dir", default=DEFAULT_SAMPLES)
    p.add_argument("--seg_sec", type=float, default=1.5)
    p.add_argument("--hop_sec", type=float, default=0.75)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    out = evaluate(args.samples_dir, seg_sec=args.seg_sec, hop_sec=args.hop_sec,
                   device=args.device)
    print(json.dumps(out, ensure_ascii=False))
    for k, v in out.items():
        print(f"{k:<32} {v}")
    return out


if __name__ == "__main__":
    main()
