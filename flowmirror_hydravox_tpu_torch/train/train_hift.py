"""HiFT vocoder GAN training CLI on one device: port of
flowmirror_hydravox_tpu/train/train_hift.py.

    python -m flowmirror_hydravox_tpu_torch.train.train_hift \
        --train_data ds/ --output_dir ckpts/hift --batch_size 4 --segment_frames 32 \
        [--grad_accum K] [--device cuda|cpu]

Dataset rows hold {"audio": {"array", "sampling_rate"}} or precomputed
{"speech" (T,), "speech_feat" (T_mel, 80), "pitch_feat" (T_mel,)}. The HiFT
and the discriminators train at f32 with AdamW (lr `--learning_rate`,
warmup 100, b1 0.8, b2 0.99, no weight decay), the JAX trainer's settings.
The weights start from a `torch.Generator` seeded with `--seed` on the
training device, and each step's vocoder draws come from a second one
seeded with `--seed + 1`, so that the draws share no stream with the init,
as the JAX trainer's init and step keys are split apart (its key chain
itself torch cannot replay). The crops and the epoch order are the JAX trainer's numpy
draws. `hift_step{n}.npz` every `--save_steps` and `hift_final.npz` at the
end are the JAX package's flat npz (the launcher serves them as hift.npz).

`--split_step` is accepted and changes nothing: the JAX trainer compiles
the two halves as two programs with it, as one without, and both give the
same update; the port always runs them one after the other. The
multi-device flags exit 2.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..config import HiFTConfig, HydraVoxConfig, MelConfig, tiny_config
from ..noise import TorchNoise
from ..params import init_disc_params, init_hift_params
from ..utils import audio as audio_utils
from . import checkpoint as ckpt
from .cli import LATER_PARALLEL, train_device
from .gan import gan_train_step
from .steps import OptimConfig, Optimizer, batch_to, init_state

logger = logging.getLogger("hydravox.train_hift")


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_hift")
    p.add_argument("--train_data", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--logging_steps", type=int, default=20)
    p.add_argument("--save_steps", type=int, default=2000)
    p.add_argument("--segment_frames", type=int, default=32,
                   help="random mel segment per sample (GAN training crops)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--split_step", action="store_true",
                   help="accepted for the JAX trainer's command lines: the two halves "
                        "always run one after the other here")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batch gradient accumulation inside each GAN step; the "
                        "generator half hands its micro-batch fakes to the disc half")
    # the JAX trainer's multi-device flags: refused
    p.add_argument("--shard_optimizer", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    args = p.parse_args(argv)
    for flag, on in (("--shard_optimizer", args.shard_optimizer), ("--fsdp", args.fsdp)):
        if on:
            p.error(f"{flag}: {LATER_PARALLEL}")
    if args.grad_accum < 1 or args.batch_size % args.grad_accum:
        p.error(f"batch_size {args.batch_size} must divide into grad_accum "
                f"{args.grad_accum} micro-batches")
    return args


def featurize(row, seg_rng: np.random.Generator, segment_frames: int, upsample: int,
              mel: MelConfig):
    """(mel (segment_frames, 80), wav (segment_frames x upsample,), pitch
    (segment_frames,)) of one row, cropped at a frame drawn from `seg_rng`
    (JAX train_hift.py:147-179): a row with audio is resampled to the mel's
    rate and its mel computed here; a row no longer than the segment is
    zero-padded from frame 0, without a draw."""
    if "speech_feat" in row and row.get("speech_feat") is not None:
        feat = np.asarray(row["speech_feat"], np.float32)
        wav = np.asarray(row["speech"], np.float32)
    else:
        audio = row["audio"]
        wav_t = audio_utils.resample_linear(
            torch.from_numpy(np.asarray(audio["array"], np.float32))[None],
            audio["sampling_rate"], mel.sample_rate)
        feat = audio_utils.mel_spectrogram(wav_t, mel.n_fft, mel.num_mels, mel.sample_rate,
                                           mel.hop_size, mel.win_size, mel.fmin,
                                           mel.fmax)[0].T.numpy()
        wav = wav_t[0].numpy()
    tm = min(feat.shape[0], len(wav) // upsample)
    seg = segment_frames
    if tm <= seg:
        start = 0
        mel_seg = np.pad(feat[:tm], ((0, seg - tm), (0, 0)))
        wav_seg = np.pad(wav[: tm * upsample], (0, (seg - tm) * upsample))
    else:
        start = int(seg_rng.integers(0, tm - seg))
        mel_seg = feat[start: start + seg]
        wav_seg = wav[start * upsample: (start + seg) * upsample]
    pitch = np.asarray(row.get("pitch_feat", np.zeros(feat.shape[0], np.float32)))
    pitch_seg = pitch[start: start + seg]
    if len(pitch_seg) < seg:
        pitch_seg = np.pad(pitch_seg, (0, seg - len(pitch_seg)))
    return mel_seg, wav_seg, pitch_seg


def batches(rows, batch_size: int, segment_frames: int, seed: int, upsample: int,
            mel: MelConfig):
    """Endless numpy batches {speech_feat, speech, pitch_feat} of `rows` (a
    sequence of dicts, or an HF dataset), in the JAX trainer's order: each
    epoch shuffled by `default_rng(seed + steps so far)`, its last partial
    batch dropped, every crop drawn from one `default_rng(seed)`."""
    if len(rows) < batch_size:
        raise ValueError(f"{len(rows)} rows make no batch of {batch_size}")
    seg_rng = np.random.default_rng(seed)
    order = np.arange(len(rows))
    nstep = 0
    while True:
        np.random.default_rng(seed + nstep).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            picked = [rows[int(i)] for i in order[start: start + batch_size]]
            mels, wavs, pitches = zip(*[featurize(r, seg_rng, segment_frames, upsample, mel)
                                        for r in picked])
            yield {"speech_feat": np.stack(mels), "speech": np.stack(wavs),
                   "pitch_feat": np.stack(pitches)}
            nstep += 1


def train(args, cfg: HiFTConfig, gen_params: dict, disc_params: dict, batch_iter,
          on_step=None):
    """Train `gen_params` and `disc_params` (trees on one device, trained in
    place) over `batch_iter` (numpy batches) until `--max_steps`, logging,
    saving and drawing as the flags in `args` say; `on_step(gen_state,
    disc_state, metrics)` runs after each step. Returns (gen_state,
    disc_state, the last step's metrics as floats)."""
    device = ckpt.tree_device(gen_params)
    optim = OptimConfig(learning_rate=args.learning_rate, warmup_steps=100,
                        total_steps=args.max_steps, weight_decay=0.0, b1=0.8, b2=0.99)
    gen_opt, disc_opt = Optimizer(optim), Optimizer(optim)
    gen_state, disc_state = init_state(gen_params, gen_opt), init_state(disc_params, disc_opt)
    # a seed of its own: the weights' generator is seeded with args.seed
    noise = TorchNoise(torch.Generator(device=device).manual_seed(args.seed + 1))
    os.makedirs(args.output_dir, exist_ok=True)
    t0, metrics = time.time(), {}
    for batch in batch_iter:
        gen_state, disc_state, metrics = gan_train_step(
            gen_state, disc_state, batch_to(batch, device), noise, cfg, gen_opt, disc_opt,
            accum_steps=args.grad_accum)
        if on_step is not None:
            on_step(gen_state, disc_state, metrics)
        nstep = gen_state.step
        if nstep % args.logging_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            logger.info("step %d gen %.3f (adv %.3f fm %.3f mel %.3f) disc %.3f (%.2f s/it)",
                        nstep, m["gen_loss"], m["adv"], m["fm"], m["mel"], m["disc_loss"],
                        (time.time() - t0) / max(args.logging_steps, 1))
            t0 = time.time()
        if nstep % args.save_steps == 0 and nstep > 0:
            ckpt.save_params_npz(f"{args.output_dir}/hift_step{nstep}.npz", gen_state.params)
        if nstep >= args.max_steps:
            break
    ckpt.save_params_npz(f"{args.output_dir}/hift_final.npz", gen_state.params)
    return gen_state, disc_state, {k: float(v) for k, v in metrics.items()}


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = train_device(args)
    full_cfg = tiny_config() if args.tiny else HydraVoxConfig()
    cfg = full_cfg.hift
    gen = torch.Generator(device=device).manual_seed(args.seed)
    gen_params = init_hift_params(cfg, gen, device, torch.float32)
    disc_params = init_disc_params(gen, device, torch.float32)

    from .data import load_hf_dataset

    train_ds, _ = load_hf_dataset(args.train_data)
    gen_state, _, metrics = train(args, cfg, gen_params, disc_params, batches(
        train_ds, args.batch_size, args.segment_frames, args.seed, cfg.upsample_scale,
        full_cfg.mel))
    return {"step": gen_state.step, "metrics": metrics}


if __name__ == "__main__":
    main()
