"""Stage 4: per-row feature extraction over a saved dataset (port of
flowmirror_hydravox_tpu/preprocess/extract_tokens.py; reference
scripts/preprocess/extract_speech_token_dataset.py), and stage 5's
`merge_datasets`.

Every row gains the columns speech_token (25 Hz FSQ tokens of the audio at
16 kHz, zero-padded to whole 640-sample frames), speech_token_len, mel (the
24 kHz 80-bin mel, (Tm, 80), trimmed with the tokens to 1:2), mel_len and
embedding (the speaker encoder over the padded 16 kHz audio's 80-bin mel).
Rows without tokens are dropped, and the result is written by the port's
`utils/hf_dataset.save_to_disk` with the features `datasets` gives JAX's
rows. A saved `DatasetDict` is featurised split by split, as
`DatasetDict.map` does.

The extractors run on `--device` (default cuda). Their weights resolve as
the port's Frontend resolves them: `--tokenizer_ckpt` / `--speaker_ckpt`,
then HYDRAVOX_TOKENIZER_NPZ / HYDRAVOX_SPEAKER_NPZ, then the committed
checkpoints in frontend/assets/ckpt/, each with the architecture of the
`.json` sidecar beside it. The JAX stage differs on both counts: without the
flags it draws a random `jax.random` init (extract_tokens.py:47-52), which
the port cannot draw, and with them it runs the file at the default
architecture, ignoring its sidecar.

`--num_proc` > 1 featurises contiguous shards of each split in that many
spawned worker processes, each with its own extractors, and keeps the rows'
order; the stage's own process then holds no device state.

Usage:
  python -m flowmirror_hydravox_tpu_torch.preprocess.extract_tokens \\
      --input_dir stage3_ds/ --output_dir stage4_ds/ [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MelConfig
from ..device import resolve_device
from ..frontend import speech_tokenizer as st
from ..frontend.frontend import TOKEN_FRAME, load_extractor
from ..utils import audio, hf_dataset

logger = logging.getLogger("hydravox.extract")


class Extractor:
    """The stage's per-row featuriser: `extractor(row)` -> the new columns."""

    def __init__(self, tokenizer_ckpt: Optional[str] = None, speaker_ckpt: Optional[str] = None,
                 mel_fmax: Optional[float] = None, device="cuda"):
        self.device = resolve_device(device)
        self.st_cfg, self.tok_params = load_extractor("tokenizer", self.device, tokenizer_ckpt)
        self.spk_cfg, self.spk_params = load_extractor("speaker", self.device, speaker_ckpt)
        self.mel_cfg = MelConfig(fmax=mel_fmax)

    @torch.inference_mode()
    def __call__(self, row: dict) -> dict:
        wav = np.ascontiguousarray(np.asarray(row["audio"]["array"], np.float32))
        sr = row["audio"]["sampling_rate"]
        x = torch.from_numpy(wav).to(self.device)[None]

        # speech tokens (16 kHz, 25 Hz frames)
        wav16 = audio.resample_linear(x, sr, 16000)
        wav16 = F.pad(wav16, (0, -wav16.shape[-1] % TOKEN_FRAME))
        tokens = st.tokenize_waveform(self.tok_params, self.st_cfg, wav16)[0].cpu().numpy()

        # 24 kHz mel, even length (train_speech_model.py:503-507 parity)
        m = self.mel_cfg
        mel = audio.mel_spectrogram(audio.resample_linear(x, sr, m.sample_rate), m.n_fft,
                                    m.num_mels, m.sample_rate, m.hop_size, m.win_size, m.fmin,
                                    m.fmax)[0].T.cpu().numpy()  # (Tm, 80)
        n = min(len(tokens), mel.shape[0] // 2)
        tokens, mel = tokens[:n], mel[: 2 * n]

        # speaker embedding from the padded 16 kHz audio's 80-bin mel
        fbank = audio.mel_spectrogram(wav16, 400, 80, 16000, 160, 400)
        emb = st.speaker_embedding(self.spk_params, self.spk_cfg, fbank)[0].cpu().numpy()
        return {
            "speech_token": tokens.tolist(),
            "speech_token_len": int(n),
            "embedding": emb.astype(np.float32),
            "mel": mel.astype(np.float32),
            "mel_len": int(mel.shape[0]),
        }


def _extract_shard(input_dir: str, split: Optional[str], lo: int, hi: int, ckpts: tuple,
                   device: str, threads: int) -> List[dict]:
    """A worker's share: the new columns of rows [lo, hi) of one split, at
    the stage's intra-op thread count (a CPU reduction's order, and so its
    rounding, follows the thread count)."""
    torch.set_num_threads(threads)
    ds = hf_dataset.load_from_disk(input_dir)
    ds = ds if split is None else ds[split]
    extract = Extractor(*ckpts, device=device)
    return [extract(ds[i]) for i in range(lo, hi)]


def featurize(ds: hf_dataset.Dataset, input_dir: str, split: Optional[str], ckpts: tuple,
              device: str, num_proc: int = 1):
    """(each row of `ds` (split `split` of the dataset at `input_dir`) with
    its new columns, in order, empty-token rows dropped; the features of
    every column), the new columns' features inferred from all the rows
    before the drop, as `datasets.map` infers them."""
    n = len(ds)
    if num_proc <= 1:
        extract = Extractor(*ckpts, device=device)
        logger.info("extracting %d rows on device %s", n, extract.device)
        new = [extract(row) for row in ds]
    else:
        bounds = np.linspace(0, n, num_proc + 1).astype(int)
        logger.info("extracting %d rows in %d processes on device %s", n, num_proc, device)
        with mp.get_context("spawn").Pool(num_proc) as pool:
            shards = pool.starmap(_extract_shard, [
                (input_dir, split, int(lo), int(hi), ckpts, device, torch.get_num_threads())
                for lo, hi in zip(bounds[:-1], bounds[1:])])
        new = [cols for shard in shards for cols in shard]
    rows = [{**row, **cols} for row, cols in zip(ds, new)]
    features = {**ds.features, **hf_dataset.infer_features(new)}
    # basic cleaning: drop empty-token rows (reference data cleaning step)
    return [r for r in rows if r["speech_token_len"] > 0], features


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--tokenizer_ckpt", default=None, help="npz weights for the FSQ tokenizer")
    p.add_argument("--speaker_ckpt", default=None)
    p.add_argument("--mel_fmax", type=float, default=None)
    p.add_argument("--num_proc", type=int, default=1)
    p.add_argument("--device", default="cuda", help="device of the extractors")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    ckpts = (args.tokenizer_ckpt, args.speaker_ckpt, args.mel_fmax)
    ds = hf_dataset.load_from_disk(args.input_dir)
    splits = ds if isinstance(ds, hf_dataset.DatasetDict) else {None: ds}
    before = after = 0
    for split, part in splits.items():
        rows, features = featurize(part, args.input_dir, split, ckpts, args.device, args.num_proc)
        hf_dataset.save_to_disk(rows, os.path.join(args.output_dir, split or ""),
                                features=features)
        before, after = before + len(part), after + len(rows)
    if None not in splits:
        hf_dataset.save_dataset_dict_json(args.output_dir, list(splits))
    logger.info("saved %d rows (%d dropped) to %s", after, before - after, args.output_dir)


def merge_datasets(paths, output_dir) -> int:
    """Stage 5 (reference data_tab.py:710): concatenate saved datasets."""
    merged = hf_dataset.concatenate_datasets([hf_dataset.load_from_disk(p) for p in paths])
    hf_dataset.save_to_disk(merged, output_dir)
    return len(merged)


if __name__ == "__main__":
    main()
