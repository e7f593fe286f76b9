"""Stage 2: voice-activity segmentation (port of
flowmirror_hydravox_tpu/preprocess/vad.py; reference
scripts/preprocess/vad_processor.py, the Silero VAD).

Two detectors share the reference's post-rules: merge segments closer than
min_gap (0.5 s), split those longer than max_dur (10 s), drop those shorter
than min_dur (0.5 s).

  - native (`--model auto` when its weights exist, or `--model native`): the
    dilated-conv frame classifier of vad_model.py, run on `--device`;
  - energy (`--model energy`): frame RMS against an adaptive noise floor with
    onset and hangover smoothing, numpy only.

`VADConfig`, `frame_energy_db` and `detect_speech` are numpy, copied from the
JAX module. Differences from the JAX stage:

  - JAX's `--cpu` is a store_true flag that defaults to True (vad.py:123-132),
    so the JAX stage always runs its model on the host. Here `--cpu` is an
    explicit request for the CPU; otherwise the model runs on `--device`
    (default cuda).
  - `--model auto` falls back to the energy VAD only when no weights exist
    (FileNotFoundError). Any other error raises, where JAX's
    `maybe_native_vad` swallows every exception and would hide a device
    fault behind the energy VAD.

Usage:
  python -m flowmirror_hydravox_tpu_torch.preprocess.vad \\
      --input_dir wav24k/ --output_dir segments/ [--model native] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("hydravox.vad")


@dataclasses.dataclass
class VADConfig:
    frame_ms: float = 30.0
    hop_ms: float = 10.0
    energy_offset_db: float = 9.0  # threshold above noise floor
    hangover_frames: int = 8  # keep speech active this many frames after drop
    onset_frames: int = 3  # frames above threshold to trigger speech
    min_gap_s: float = 0.5
    min_dur_s: float = 0.5
    max_dur_s: float = 10.0


def frame_energy_db(wav: np.ndarray, sr: int, cfg: VADConfig) -> Tuple[np.ndarray, int]:
    frame = int(sr * cfg.frame_ms / 1000)
    hop = int(sr * cfg.hop_ms / 1000)
    n = max(1 + (len(wav) - frame) // hop, 1)
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    idx = np.minimum(idx, len(wav) - 1)
    frames = wav[idx]
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    return 20 * np.log10(rms), hop


def detect_speech(
    wav: np.ndarray,
    sr: int,
    cfg: Optional[VADConfig] = None,
    speech_prob_fn: Optional[Callable] = None,
) -> List[Tuple[float, float]]:
    """Returns [(start_s, end_s), ...] speech segments."""
    cfg = cfg or VADConfig()
    if speech_prob_fn is not None:
        probs, hop = speech_prob_fn(wav, sr), int(sr * cfg.hop_ms / 1000)
        active = probs > 0.5
    else:
        e_db, hop = frame_energy_db(wav, sr, cfg)
        floor = np.percentile(e_db, 10)
        active = e_db > (floor + cfg.energy_offset_db)

    # onset/hangover smoothing
    segs, state, run, last_active = [], False, 0, -10 ** 9
    start = 0
    for i, a in enumerate(active):
        if not state:
            run = run + 1 if a else 0
            if run >= cfg.onset_frames:
                state, start = True, i - run + 1
        else:
            if a:
                last_active = i
            elif i - last_active > cfg.hangover_frames:
                segs.append((start, i))
                state, run = False, 0
        if a:
            last_active = i
    if state:
        segs.append((start, len(active)))

    hop_s = hop / sr
    out = [(s * hop_s, e * hop_s) for s, e in segs]

    # merge close segments (< min_gap)
    merged: List[Tuple[float, float]] = []
    for s, e in out:
        if merged and s - merged[-1][1] < cfg.min_gap_s:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))

    # split long, drop short
    final = []
    for s, e in merged:
        while e - s > cfg.max_dur_s:
            final.append((s, s + cfg.max_dur_s))
            s += cfg.max_dur_s
        if e - s >= cfg.min_dur_s:
            final.append((s, e))
    return final


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--min_dur", type=float, default=0.5)
    p.add_argument("--max_dur", type=float, default=10.0)
    p.add_argument("--min_gap", type=float, default=0.5)
    p.add_argument("--model", choices=["auto", "native", "energy"], default="auto",
                   help="auto = trained native VAD when its weights exist, "
                        "else energy fallback")
    p.add_argument("--cpu", action="store_true",
                   help="run the native model on the host CPU (same as --device cpu)")
    p.add_argument("--device", default="cuda", help="device of the native model")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..utils.wavio import decode_wav, encode_wav

    speech_prob_fn = None
    if args.model in ("auto", "native"):
        from .vad_model import maybe_native_vad

        native = maybe_native_vad(device="cpu" if args.cpu else args.device)
        if native is not None:
            speech_prob_fn = native
            logger.info("using trained native VAD on device %s", native.device)
        elif args.model == "native":
            raise SystemExit("no trained VAD weights (preprocess/assets/vad.npz "
                             "or HYDRAVOX_VAD_NPZ)")
        else:
            logger.info("no trained VAD weights; using energy VAD")

    cfg = VADConfig(min_dur_s=args.min_dur, max_dur_s=args.max_dur,
                    min_gap_s=args.min_gap)
    n_seg = n_bad = 0
    for path in Path(args.input_dir).rglob("*.wav"):
        try:
            with open(path, "rb") as f:
                wav, sr = decode_wav(f.read())
        except Exception as e:  # skip unreadable, keep segmenting the rest
            logger.warning("skipping unreadable %s (%s)", path, e)
            n_bad += 1
            continue
        for i, (s, e) in enumerate(
                detect_speech(wav, sr, cfg, speech_prob_fn=speech_prob_fn)):
            seg = wav[int(s * sr) : int(e * sr)]
            rel = path.relative_to(args.input_dir)
            dst = Path(args.output_dir) / rel.parent / f"{rel.stem}_{i:04d}.wav"
            os.makedirs(dst.parent, exist_ok=True)
            with open(dst, "wb") as f:
                f.write(encode_wav(seg, sr))
            n_seg += 1
    logger.info("emitted %d segments (%d unreadable files skipped)", n_seg, n_bad)


if __name__ == "__main__":
    main()
