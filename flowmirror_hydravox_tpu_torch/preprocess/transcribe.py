"""Stage 3: audio (+ transcripts or ASR) -> a saved dataset (port of
flowmirror_hydravox_tpu/preprocess/transcribe.py; reference
scripts/preprocess/transcribe_to_dataset.py:37-637).

The orchestration is JAX's:

  - transcript sources, in priority order per file: a sidecar `<name>.txt`
    (transcribe_to_dataset.py:174-195), the `--transcript_file` TSV/JSONL
    table, the `--asr_module` callable `fn(wav, sr) -> str`, the file name
    (`--no_filename_fallback` drops untranscribed files instead);
  - `--num_workers` spawn-context worker processes, each with its own ASR
    instance, over contiguous chunks of the sorted files (reference
    worker_process / process_files_multiprocess:219-418);
  - text cleaning: spaces between CJK characters dropped, whitespace
    collapsed (post_process_text:72-93); empty texts dropped;
  - audio cleaning: mono downmix, 16 kHz linear resampling, loudness
    normalisation with a 0.95 clip guard (pyloudnorm's LUFS when installed,
    else RMS; normalize_loudness / simple_normalize:95-172), `--min_sec`;
  - corpus statistics (rows, hours, duration histogram, text lengths, skip
    reasons) in `corpus_stats.json` beside the dataset.

The rows are {text, audio: {array (float32), sampling_rate}}, written by the
port's `utils/hf_dataset.save_to_disk` (never `datasets`), with the features
`datasets` gives the JAX stage's rows. `--asr_module native` is the port's
`NativeASR` on `--device` (default cuda).

Usage:
  python -m flowmirror_hydravox_tpu_torch.preprocess.transcribe \\
      --input_dir segments/ --output_dir stage3_ds/ [--asr_module native]
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import math
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("hydravox.transcribe")

SR = 16000
SKIP_REASONS = ("unreadable", "too_short", "no_transcript", "empty_text")


def load_transcripts(path: str) -> dict:
    table = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                row = json.loads(line)
                table[row["audio"]] = row["text"]
            else:
                parts = line.split("\t", 1)
                if len(parts) == 2:
                    table[parts[0]] = parts[1]
    return table


def clean_text(text: str) -> str:
    """Reference post_process_text: drop spaces between CJK chars, collapse
    whitespace (transcribe_to_dataset.py:72-93)."""
    text = re.sub(r"([一-鿿])\s+([一-鿿])", r"\1\2", text)
    text = re.sub(r"([一-鿿])\s+([一-鿿])", r"\1\2", text)
    return re.sub(r"\s+", " ", text).strip()


def normalize_loudness(wav: np.ndarray, target_rms: float = 0.1,
                       target_lufs: float = -23.0, sr: int = SR) -> np.ndarray:
    """LUFS normalization when pyloudnorm exists, else RMS; 0.95 clip guard
    (reference normalize_loudness/simple_normalize:95-172)."""
    try:
        import pyloudnorm as pyln  # gated external, like the reference

        loudness = pyln.Meter(sr).integrated_loudness(wav.astype(np.float64))
        if math.isfinite(loudness):
            wav = wav * (10.0 ** ((target_lufs - loudness) / 20.0))
            peak = np.abs(wav).max()
            return wav / peak * 0.95 if peak > 0.95 else wav
    except Exception:
        pass
    rms = float(np.sqrt(np.mean(wav ** 2)))
    if rms == 0:
        return wav
    wav = wav * (target_rms / rms)
    peak = np.abs(wav).max()
    return (wav / peak * 0.95 if peak > 0.95 else wav).astype(np.float32)


def _resample_mono(wav: np.ndarray, sr: int) -> np.ndarray:
    if wav.ndim == 2:  # (C, T) or (T, C) -> mono downmix
        wav = wav.mean(axis=0 if wav.shape[0] <= 2 else 1)
    if sr == SR:
        return wav.astype(np.float32)
    n = int(len(wav) * SR / sr)
    src = np.linspace(0, len(wav) - 1, n)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, len(wav) - 1)
    w = (src - lo).astype(np.float32)
    return (wav[lo] * (1 - w) + wav[hi] * w).astype(np.float32)


def process_files(files: List[Path], input_dir: str,
                  transcripts: Dict[str, str], asr, min_sec: float,
                  normalize: bool, filename_fallback: bool,
                  stats: Dict[str, int]) -> List[dict]:
    """One worker's share: per file, resolve text (sidecar txt > table > ASR >
    filename), clean audio + text, drop too-short/empty."""
    from ..utils.wavio import decode_wav

    records = []
    for path in files:
        try:
            with open(path, "rb") as f:
                wav, sr = decode_wav(f.read())
        except Exception as e:
            logger.warning("unreadable %s (%s)", path, e)
            stats["unreadable"] += 1
            continue
        wav = _resample_mono(np.asarray(wav), sr)
        if len(wav) < min_sec * SR:
            stats["too_short"] += 1
            continue
        txt_path = path.with_suffix(".txt")
        key_abs, key_rel = str(path), str(path.relative_to(input_dir))
        if txt_path.exists():  # sidecar txt wins (reference :174-195)
            text = txt_path.read_text(encoding="utf-8", errors="replace").strip()
        elif key_abs in transcripts or key_rel in transcripts:
            text = transcripts.get(key_abs, transcripts.get(key_rel))
        elif asr is not None:
            text = asr(wav, SR)
        elif filename_fallback:
            text = path.stem.replace("_", " ")
        else:
            stats["no_transcript"] += 1
            continue
        text = clean_text(text or "")
        if not text:
            stats["empty_text"] += 1
            continue
        if normalize:
            wav = normalize_loudness(wav)
        records.append({"text": text,
                        "audio": {"array": wav.astype(np.float32),
                                  "sampling_rate": SR}})
    return records


def _worker(worker_id: int, files: List[str], input_dir: str,
            transcript_file: Optional[str], asr_module: Optional[str],
            min_sec: float, normalize: bool, filename_fallback: bool,
            out_path: str, device: str):
    """Process-pool worker: writes its records + stats to `out_path` (npz of
    json rows; audio kept float32). Loads the ASR hook in-process so each
    worker owns its model instance (reference worker_process:219-247)."""
    logging.basicConfig(level=logging.INFO)
    transcripts = load_transcripts(transcript_file) if transcript_file else {}
    asr = _load_asr(asr_module, device)
    stats: Dict[str, int] = {k: 0 for k in SKIP_REASONS}
    records = process_files([Path(f) for f in files], input_dir, transcripts,
                            asr, min_sec, normalize, filename_fallback, stats)
    np.savez_compressed(
        out_path,
        texts=np.asarray([r["text"] for r in records], dtype=object),
        audios=np.asarray([r["audio"]["array"] for r in records], dtype=object),
        stats=json.dumps(stats),
    )
    logger.info("worker %d: %d records", worker_id, len(records))


def _load_asr(asr_module: Optional[str], device: str):
    if not asr_module:
        return None
    if asr_module == "native":  # the in-repo CTC recognizer (asr_model.py)
        from .asr_model import NativeASR

        asr = NativeASR(device=device)
        logger.info("native ASR on device %s", asr.device)
        return asr
    mod, fn = asr_module.rsplit(".", 1)
    return getattr(importlib.import_module(mod), fn)


def build_dataset(records: List[dict], output_dir: str, batch_size: int = 1000) -> int:
    """Write the rows in record batches of `batch_size` (the reference's
    batched build bounds peak memory, build_dataset:418-470); returns the
    row count."""
    from ..utils import hf_dataset

    hf_dataset.save_to_disk([{"text": r["text"], "audio": r["audio"]} for r in records],
                            output_dir, writer_batch_size=batch_size)
    return len(records)


def corpus_stats(records: List[dict], skip_stats: Dict[str, int]) -> dict:
    durs = [len(r["audio"]["array"]) / SR for r in records]
    tlens = [len(r["text"]) for r in records]
    hist_edges = [0, 1, 2, 4, 6, 8, 10, 15, 20, 30, 1e9]
    hist = {f"{int(a)}-{int(b) if b < 1e9 else 'inf'}s":
            int(sum(a <= d < b for d in durs))
            for a, b in zip(hist_edges[:-1], hist_edges[1:])}
    return {
        "rows": len(records),
        "hours": round(sum(durs) / 3600.0, 3),
        "duration_s": {"mean": round(float(np.mean(durs)), 2) if durs else 0,
                       "p50": round(float(np.median(durs)), 2) if durs else 0,
                       "max": round(max(durs), 2) if durs else 0},
        "duration_hist": hist,
        "text_chars": {"mean": round(float(np.mean(tlens)), 1) if tlens else 0,
                       "max": max(tlens) if tlens else 0},
        "skipped": skip_stats,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--transcript_file", default=None)
    p.add_argument("--asr_module", default=None,
                   help="dotted path to `fn(wav: np.ndarray, sr: int) -> str`, or native")
    p.add_argument("--num_workers", type=int, default=1,
                   help="process fan-out (reference :324-418)")
    p.add_argument("--min_sec", type=float, default=0.3,
                   help="drop clips shorter than this (reference --min_sec)")
    p.add_argument("--normalize_loudness", action="store_true",
                   help="RMS/LUFS loudness normalization (reference :95-172)")
    p.add_argument("--no_filename_fallback", action="store_true",
                   help="drop files with no transcript instead of using the "
                        "filename as text")
    p.add_argument("--batch_size", type=int, default=1000,
                   help="dataset build batch (reference --batch_size)")
    p.add_argument("--device", default="cuda", help="device of the native ASR")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    files = sorted(list(Path(args.input_dir).rglob("*.wav")))
    if not files:
        raise SystemExit(f"no wav files under {args.input_dir}")
    # no cpu_count cap: ASR workers are usually model/IO-bound, and the
    # explicit request wins (reference caps CPU workers, :598-601, but its
    # GPU path deliberately oversubscribes)
    num_workers = max(1, min(args.num_workers, len(files)))
    filename_fallback = not args.no_filename_fallback

    skip_stats: Dict[str, int] = {k: 0 for k in SKIP_REASONS}
    if num_workers == 1:
        transcripts = (load_transcripts(args.transcript_file)
                       if args.transcript_file else {})
        records = process_files(files, args.input_dir, transcripts,
                                _load_asr(args.asr_module, args.device), args.min_sec,
                                args.normalize_loudness, filename_fallback,
                                skip_stats)
    else:
        import multiprocessing as mp
        import tempfile

        chunk = math.ceil(len(files) / num_workers)
        chunks = [files[i:i + chunk] for i in range(0, len(files), chunk)]
        logger.info("fanning out %d files over %d workers", len(files), len(chunks))
        ctx = mp.get_context("spawn")  # reference :343 (accelerator-safe)
        with tempfile.TemporaryDirectory() as tmp:
            outs, procs = [], []
            for i, ch in enumerate(chunks):
                out = os.path.join(tmp, f"worker_{i}.npz")
                outs.append(out)
                proc = ctx.Process(target=_worker, args=(
                    i, [str(f) for f in ch], args.input_dir,
                    args.transcript_file, args.asr_module, args.min_sec,
                    args.normalize_loudness, filename_fallback, out, args.device))
                proc.start()
                procs.append(proc)
            records = []
            for i, proc in enumerate(procs):
                proc.join()
                if proc.exitcode != 0 or not os.path.exists(outs[i]):
                    logger.warning("worker %d failed (exit %s)", i, proc.exitcode)
                    continue
                data = np.load(outs[i], allow_pickle=True)  # this stage's own worker's file
                for t, a in zip(data["texts"], data["audios"]):
                    records.append({"text": str(t),
                                    "audio": {"array": np.asarray(a, np.float32),
                                              "sampling_rate": SR}})
                for k, v in json.loads(str(data["stats"])).items():
                    skip_stats[k] += v

    if not records:
        raise SystemExit("no records extracted")
    n_rows = build_dataset(records, args.output_dir, args.batch_size)
    stats = corpus_stats(records, skip_stats)
    with open(os.path.join(args.output_dir, "corpus_stats.json"), "w") as f:
        json.dump(stats, f, indent=1, ensure_ascii=False)
    logger.info("saved %d rows (%.2f h) to %s; stats: %s", n_rows,
                stats["hours"], args.output_dir, stats)


if __name__ == "__main__":
    main()
