"""Train the native VAD (preprocess/vad_model.py) on synthetic speech + noise
mixtures with exact activity labels: port of
flowmirror_hydravox_tpu/train/train_vad.py.

The formant synthesizer (train/synth_speech.py) knows where it placed
speech and pauses. Each example mixes an utterance with white, pink, hum or
babble noise at an SNR in [-5, 30] dB, or is pure noise or clean speech, so
the classifier learns spectro-temporal speech structure rather than energy
(tools/eval_vad.py measures the gap to the energy VAD).

    python -m flowmirror_hydravox_tpu_torch.train.train_vad \\
        --output_dir ckpt/vad --max_steps 2000 [--device cuda|cpu]

The flags are the JAX trainer's plus `--device` (default cuda; it raises
without a GPU). The batches are the JAX trainer's, byte for byte (numpy,
built on a host thread ahead of the step); the initial tree is drawn from a
`torch.Generator` seeded with `--seed`. The optimizer is JAX's
`optax.adamw(warmup_cosine)` with no gradient clip (the port's `Optimizer`
with `grad_clip=inf` and optax.adamw's weight decay 1e-4), except that an
update whose gradient norm is not finite is skipped. Writes
`<output_dir>/vad.npz` in fp16, which `NativeVAD(path)` and the JAX
package's both load.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time

import numpy as np
import torch

logger = logging.getLogger("hydravox.train_vad")

SR = 16000
HOP = 160  # 10 ms


# Copied from flowmirror_hydravox_tpu/train/train_vad.py (numpy; the same batches).
def mixture_batches(batch_size: int, seconds: float, seed: int,
                    speech_pool: int = 768, noise_pool: int = 48):
    """(wavs (B,T), frame_labels (B,F)) with F = T//HOP.

    Synthesis is the bottleneck on a weak host (babble noise alone costs
    ~0.5 s/clip), so speech+masks and noise clips are pre-generated into
    pools and batches sample random crops — same distribution family, ~100x
    cheaper per step after warmup."""
    from .synth_speech import synth_noise, synth_utterance_with_mask

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7AD]))
    n = int(seconds * SR)
    pool_n = n + SR  # 1 s of crop slack
    kinds = ["white", "pink", "hum", "babble"]
    speech_wavs, speech_masks = [], []
    for u in range(speech_pool):
        w, m = synth_utterance_with_mask(u % 256, u, pool_n / SR, seed=1)
        speech_wavs.append(w[:pool_n])
        speech_masks.append(m[:pool_n])
    noises = [synth_noise(kinds[i % len(kinds)], pool_n, rng)
              for i in range(noise_pool)]

    while True:
        wavs, labels = [], []
        for _ in range(batch_size):
            mode = rng.random()
            start = int(rng.integers(0, pool_n - n))
            if mode < 0.15:  # pure noise — label all zero
                wav = noises[int(rng.integers(noise_pool))][start:start + n].copy()
                wav = wav * rng.uniform(0.01, 0.6)
                mask = np.zeros(n, np.uint8)
            else:
                i = int(rng.integers(speech_pool))
                speech = speech_wavs[i][start:start + n]
                mask = speech_masks[i][start:start + n]
                if mode < 0.85:  # noisy mixture at random SNR
                    j = int(rng.integers(noise_pool))
                    noise = noises[j][start:start + n]
                    snr_db = rng.uniform(-5.0, 30.0)
                    sp = np.sqrt(np.mean(speech**2) + 1e-9)
                    npow = np.sqrt(np.mean(noise**2) + 1e-9)
                    wav = speech + noise * (sp / npow) * (10.0 ** (-snr_db / 20.0))
                else:  # clean
                    wav = speech.copy()
                wav = wav * rng.uniform(0.05, 1.0)
                peak = np.abs(wav).max()
                if peak > 1.0:
                    wav = wav / peak
            # frame label = any speech sample in the frame's hop window
            f = n // HOP
            mlab = mask[: f * HOP].reshape(f, HOP).max(axis=1)
            wavs.append(wav.astype(np.float32))
            labels.append(mlab)
        yield np.stack(wavs), np.stack(labels)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # port only: the synthetic pools' sizes (JAX's fixed 768 and 48 by default)
    p.add_argument("--speech_pool", type=int, default=768)
    p.add_argument("--noise_pool", type=int, default=48)
    return p.parse_args(argv)


def optimizer(learning_rate: float, max_steps: int):
    """JAX's `optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup,
    max(max_steps, warmup + 1)))`, warmup = min(100, max(max_steps // 10, 1)),
    no clip (train_vad.py:112-114)."""
    from .steps import OptimConfig, Optimizer

    warmup = min(100, max(max_steps // 10, 1))
    return Optimizer(OptimConfig(learning_rate=learning_rate, warmup_steps=warmup,
                                 weight_decay=1e-4, grad_clip=math.inf,
                                 total_steps=max(max_steps, warmup + 1)))


def main(argv=None, on_step=None):
    """Train and save; returns the final `TrainState`. `on_step(state,
    metrics)` runs after each step (chip_smoke.py times steps with it)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..preprocess import vad_model
    from .checkpoint import save_params_npz
    from .cli import train_device
    from .data import Prefetch
    from .steps import batch_to, init_state, loss_train_step

    device = train_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = vad_model.VADModelConfig()
    params = vad_model.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt = optimizer(args.learning_rate, args.max_steps)
    state = init_state(params, opt)

    def loss_fn(p, b):
        loss, acc = vad_model.bce_loss(p, cfg, b["wavs"], b["labels"])
        return loss, {"acc": acc}

    t0 = time.time()
    with Prefetch(mixture_batches(args.batch_size, args.seconds, args.seed, args.speech_pool,
                                  args.noise_pool)) as prefetch:
        batches = iter(prefetch)
        for i in range(args.max_steps):
            wavs, labels = next(batches)
            state, metrics = loss_train_step(
                state, batch_to({"wavs": wavs, "labels": labels}, device), loss_fn, opt)
            if on_step is not None:
                on_step(state, metrics)
            if (i + 1) % args.logging_steps == 0 or i == 0:
                logger.info("step %d loss %.4f acc %.3f (%.1fs)", i + 1,
                            float(metrics["loss"]), float(metrics["acc"]), time.time() - t0)
    save_params_npz(os.path.join(args.output_dir, "vad.npz"), state.params, np.float16)
    logger.info("done: %s", args.output_dir)
    return state


if __name__ == "__main__":
    main()
