"""Stage 1: convert and resample audio to mono WAV at a target rate (port of
flowmirror_hydravox_tpu/preprocess/resample.py; reference
scripts/preprocess/{convert_to_wav.py,resample_mono.py}).

ffmpeg, when present, converts any container, as in JAX, in a pool of
`--num_workers` processes (each runs a subprocess, so nothing of the device
enters the pool). A WAV that ffmpeg did not convert (no ffmpeg, or it failed)
is decoded with the standard library and resampled with `resample_linear` in
the stage's own process, on `--device`: the JAX stage resamples in each pool
worker, which here would give every worker a CUDA context of its own.

Usage:
  python -m flowmirror_hydravox_tpu_torch.preprocess.resample \\
      --input_dir raw/ --output_dir wav24k/ --sample_rate 24000 [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
import shutil
import subprocess
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

logger = logging.getLogger("hydravox.resample")

AUDIO_EXTS = {".wav", ".mp3", ".flac", ".ogg", ".m4a", ".aac", ".opus", ".wma"}


def _ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def ffmpeg_convert(src: str, dst: str, sample_rate: int) -> bool:
    """One file -> mono 16-bit WAV at sample_rate through ffmpeg."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    r = subprocess.run(
        ["ffmpeg", "-y", "-v", "error", "-i", src, "-ac", "1",
         "-ar", str(sample_rate), "-acodec", "pcm_s16le", dst],
        capture_output=True,
    )
    if r.returncode == 0:
        return True
    logger.warning("ffmpeg failed on %s: %s", src, r.stderr.decode()[:200])
    return False


def resample_wav(src: str, dst: str, sample_rate: int, device) -> bool:
    """A WAV -> mono WAV at sample_rate, resampled on `device`; any other
    container fails (it needs ffmpeg)."""
    if not src.lower().endswith(".wav"):
        logger.error("cannot convert %s (no ffmpeg, not wav)", src)
        return False
    import torch

    from ..utils.audio import resample_linear
    from ..utils.wavio import decode_wav, encode_wav

    with open(src, "rb") as f:
        wav, sr = decode_wav(f.read())
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(device)[None]
    out = resample_linear(x, sr, sample_rate)[0].cpu().numpy()
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "wb") as f:
        f.write(encode_wav(out, sample_rate))
    return True


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--num_workers", type=int, default=os.cpu_count(),
                   help="ffmpeg conversions at a time")
    p.add_argument("--device", default="cuda", help="device of the WAV resampling")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    jobs = []
    for src in Path(args.input_dir).rglob("*"):
        if src.suffix.lower() in AUDIO_EXTS:
            rel = src.relative_to(args.input_dir).with_suffix(".wav")
            jobs.append((str(src), str(Path(args.output_dir) / rel)))
    logger.info("converting %d files", len(jobs))
    ok, rest = 0, jobs
    if jobs and _ffmpeg_available():
        with ProcessPoolExecutor(args.num_workers, mp_context=mp.get_context("spawn")) as ex:
            done = [ex.submit(ffmpeg_convert, src, dst, args.sample_rate) for src, dst in jobs]
            converted = [f.result() for f in done]
        ok = sum(converted)
        rest = [job for job, c in zip(jobs, converted) if not c]
        logger.info("ffmpeg converted %d/%d files", ok, len(jobs))
    if rest:
        from ..device import resolve_device

        device = resolve_device(args.device)
        logger.info("resampling %d files on device %s", len(rest), device)
        ok += sum(resample_wav(src, dst, args.sample_rate, device) for src, dst in rest)
    logger.info("done: %d/%d converted", ok, len(jobs))


if __name__ == "__main__":
    main()
