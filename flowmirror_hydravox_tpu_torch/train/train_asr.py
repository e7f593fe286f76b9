"""Train the native CTC ASR (preprocess/asr_model.py): port of
flowmirror_hydravox_tpu/train/train_asr.py.

Two data paths:

  - default: the deterministic synthetic corpus (train/synth_speech.py),
    each utterance transcribed by its ordered phoneme-like segment symbols,
    with light noise augmentation. The shipped checkpoint
    (preprocess/assets/asr.npz) comes from this recipe.

      python -m flowmirror_hydravox_tpu_torch.train.train_asr \\
          --output_dir ckpt/asr --max_steps 3000 [--device cuda|cpu]

  - --dataset DIR: a saved dataset with {text, audio {array,
    sampling_rate}} rows (the stage-3 schema), read by the port's own
    reader (utils/hf_dataset.py); a character vocabulary (or `--sep`
    units) is built from its texts.

The flags are the JAX trainer's plus `--device` (default cuda; it raises
without a GPU). On the synthetic path the int16 pool goes to the device
once, and each step's batch (rows, noise rows, SNR, on/off, gain) is drawn
there from a `torch.Generator` seeded with `--seed + 1`, as JAX draws it
there with `jax.random` in a `lax.scan` (so the draws differ); no audio
crosses from the host after the pool. JAX's scan reads the host only at a
log line; here each step waits on the host once, because
`torch.nn.functional.ctc_loss` copies the sequence lengths to it (and the
`Optimizer` reads its non-finite flag). The dataset path assembles batches
on a host thread. The loss and the emitting fraction are logged at JAX's
cadence (every `--logging_steps` steps and the last on the synthetic path;
step 1 and every `--logging_steps` on the dataset path).

The optimizer is JAX's `optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine))`, warmup = min(200, max(max_steps // 10, 1)), weight
decay 1e-4 (the port's `Optimizer`), except that an update whose gradient
norm is not finite is skipped. The initial tree is drawn from a
`torch.Generator` seeded with `--seed`. Writes `<output_dir>/asr.npz` in
fp16 through `asr_model.save_ckpt`.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("hydravox.train_asr")

SR = 16000


# Copied from flowmirror_hydravox_tpu/train/train_asr.py (numpy; the same pool).
def synthetic_pool(seconds: float, seed: int, vocab, n_speakers: int = 256,
                   pool: int = 768, noise_pool: int = 32, max_label: int = 48):
    """Finite synthetic corpus as dense int16 arrays, built host-side once:
    {speech (P,T) i16, labels (P,L) i32, label_len (P,) i32, noise (N,T) i16}.

    The training loop moves this to the device once and draws batches and
    noise augmentation there (see main).

    Clip synthesis is pinned to corpus seed=1 BY DESIGN (only the noise pool
    varies with `seed`): tools/eval_asr holds out by (speaker, utterance) id
    against this fixed seed-1 corpus, so varying the clip seed would silently
    break the held-out split contract."""
    from concurrent.futures import ThreadPoolExecutor

    from .synth_speech import synth_noise, synth_utterance_with_segments

    sym_to_id = {s: i + 1 for i, s in enumerate(vocab)}
    n = int(seconds * SR)
    with ThreadPoolExecutor(8) as ex:
        clips = list(ex.map(
            lambda u: synth_utterance_with_segments(u % n_speakers, u,
                                                    seconds, seed=1),
            range(pool)))
        noises = list(ex.map(
            lambda i: synth_noise(["white", "pink", "hum", "babble"][i % 4],
                                  n, np.random.default_rng(
                                      np.random.SeedSequence([seed, 0xA53, i]))),
            range(noise_pool)))
    speech, labels, label_len = [], [], []
    for w, segs in clips:
        if not segs or len(segs) > max_label:
            continue
        speech.append(np.clip(w[:n] * 32767.0, -32767, 32767).astype(np.int16))
        lab = np.zeros(max_label, np.int32)
        lab[:len(segs)] = [sym_to_id[s] for s in segs]
        labels.append(lab)
        label_len.append(len(segs))
    return {
        "speech": np.stack(speech),
        "labels": np.stack(labels),
        "label_len": np.asarray(label_len, np.int32),
        "noise": np.stack([np.clip(z * 32767.0, -32767, 32767).astype(np.int16)
                           for z in noises]),
    }


# Copied from flowmirror_hydravox_tpu/train/train_asr.py (numpy; the same batches).
def synthetic_batches(batch_size: int, seconds: float, seed: int, vocab,
                      n_speakers: int = 256, pool: int = 768,
                      noise_pool: int = 32, max_label: int = 48):
    """Host-side generator over the synthetic pool — used by tests and CPU
    runs; (wavs (B,T) f32, wav_len, labels (B,L), label_len), labels 1-based
    (0 = CTC blank), mild noise augmentation (SNR 10-40 dB or clean)."""
    p = synthetic_pool(seconds, seed, vocab, n_speakers, pool, noise_pool,
                       max_label)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA52]))
    n = int(seconds * SR)
    n_pool, n_noise = len(p["speech"]), len(p["noise"])
    while True:
        idx = rng.integers(0, n_pool, batch_size)
        wavs = p["speech"][idx].astype(np.float32) / 32767.0
        for r in range(batch_size):
            if rng.random() < 0.5:
                noise = (p["noise"][int(rng.integers(n_noise))]
                         .astype(np.float32) / 32767.0)
                snr_db = rng.uniform(10.0, 40.0)
                sp = np.sqrt(np.mean(wavs[r] ** 2) + 1e-9)
                npow = np.sqrt(np.mean(noise ** 2) + 1e-9)
                wavs[r] += noise * (sp / npow) * (10.0 ** (-snr_db / 20.0))
            wavs[r] *= rng.uniform(0.3, 1.0)
        yield (wavs, np.full(batch_size, n, np.int32),
               p["labels"][idx], p["label_len"][idx])


def dataset_batches(dataset_dir: str, batch_size: int, seconds: float,
                    seed: int, sep: str, max_label: int):
    """The dataset path: (vocab, an endless batch generator). Rows longer
    than `seconds` or `max_label` units, or with no unit, are dropped; audio
    is resampled to 16 kHz on the host. Raises SystemExit when no row is
    usable (JAX train_asr.py:111-154)."""
    from ..preprocess.transcribe import _resample_mono
    from ..utils import hf_dataset

    ds = hf_dataset.load_from_disk(dataset_dir)
    units = sorted({u for row in ds
                    for u in (row["text"].split(sep) if sep else row["text"])
                    if u})
    sym_to_id = {s: i + 1 for i, s in enumerate(units)}
    n = int(seconds * SR)
    rows = []
    for row in ds:
        wav = _resample_mono(np.asarray(row["audio"]["array"], np.float32),
                             int(row["audio"]["sampling_rate"]))
        lab = [sym_to_id[u]
               for u in (row["text"].split(sep) if sep else row["text"]) if u]
        if 0 < len(lab) <= max_label and len(wav) <= n:
            rows.append((wav, lab))
    if not rows:
        raise SystemExit("no usable rows (check --seconds / --max_label)")
    logger.info("dataset: %d usable rows, vocab %d", len(rows), len(units))

    def gen():
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.integers(0, len(rows), batch_size)
            wavs = np.zeros((batch_size, n), np.float32)
            wav_len = np.zeros(batch_size, np.int32)
            labels = np.zeros((batch_size, max_label), np.int32)
            label_len = np.zeros(batch_size, np.int32)
            for r, i in enumerate(idx):
                wav, lab = rows[i]
                wavs[r, :len(wav)] = wav
                wav_len[r] = len(wav)
                labels[r, :len(lab)] = lab
                label_len[r] = len(lab)
            yield wavs, wav_len, labels, label_len

    return units, gen()


class DeviceBatches:
    """The synthetic pool on `device` (int16 audio) and each step's batch
    drawn there (JAX train_asr.py:225-240): B pool rows, B noise rows, SNR
    in [10, 40) dB, noise on with probability 0.5, gain in [0.3, 1.0)."""

    def __init__(self, pool: dict, batch_size: int, seconds: float, device,
                 generator: torch.Generator):
        self.dev = {k: torch.from_numpy(v).to(device) for k, v in pool.items()}
        self.b, self.n, self.device, self.gen = batch_size, int(seconds * SR), device, generator

    def _uniform(self, lo: float, hi: float):
        return torch.rand(self.b, generator=self.gen, device=self.device) * (hi - lo) + lo

    def __call__(self) -> dict:
        b, dev = self.b, self.dev
        idx = torch.randint(0, dev["speech"].shape[0], (b,), generator=self.gen,
                            device=self.device)
        noise_idx = torch.randint(0, dev["noise"].shape[0], (b,), generator=self.gen,
                                  device=self.device)
        wav = dev["speech"][idx].float() / 32767.0
        noise = dev["noise"][noise_idx].float() / 32767.0
        snr_db = self._uniform(10.0, 40.0)
        use = (self._uniform(0.0, 1.0) < 0.5).float()
        sp = torch.sqrt(torch.mean(wav ** 2, dim=1) + 1e-9)
        npow = torch.sqrt(torch.mean(noise ** 2, dim=1) + 1e-9)
        gain = use * (sp / npow) * 10.0 ** (-snr_db / 20.0)
        wav = (wav + noise * gain[:, None]) * self._uniform(0.3, 1.0)[:, None]
        return {"wavs": wav,
                "wav_len": torch.full((b,), self.n, dtype=torch.int32, device=self.device),
                "labels": dev["labels"][idx], "label_len": dev["label_len"][idx]}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dataset", default=None,
                   help="saved dataset dir ({text, audio} rows); default = "
                        "synthetic segment corpus")
    p.add_argument("--sep", default="",
                   help="text unit separator for --dataset ('' = chars)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--max_label", type=int, default=48)
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--max_steps", type=int, default=3000)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # port only: the synthetic pool's sizes (JAX's fixed 768 and 32 by default)
    p.add_argument("--pool", type=int, default=768)
    p.add_argument("--noise_pool", type=int, default=32)
    return p.parse_args(argv)


def optimizer(learning_rate: float, max_steps: int):
    """JAX's `optax.chain(clip_by_global_norm(1.0),
    adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(max_steps,
    warmup + 1))))`, warmup = min(200, max(max_steps // 10, 1))
    (train_asr.py:200-205)."""
    from .steps import OptimConfig, Optimizer

    warmup = min(200, max(max_steps // 10, 1))
    return Optimizer(OptimConfig(learning_rate=learning_rate, warmup_steps=warmup,
                                 weight_decay=1e-4, grad_clip=1.0,
                                 total_steps=max(max_steps, warmup + 1)))


def main(argv=None, on_step=None):
    """Train and save; returns the final `TrainState`. `on_step(state,
    metrics)` runs after each step (chip_smoke.py times steps with it)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..preprocess import asr_model
    from .cli import train_device
    from .data import Prefetch
    from .steps import batch_to, init_state, loss_train_step, tree_leaves
    from .synth_speech import FRIC_SYMBOLS, VOWEL_SYMBOLS

    device = train_device(args)
    if args.dataset:
        vocab, gen = dataset_batches(args.dataset, args.batch_size, args.seconds,
                                     args.seed, args.sep, args.max_label)
        pool = None
    else:
        vocab = list(VOWEL_SYMBOLS) + list(FRIC_SYMBOLS)
        t0 = time.time()
        pool = synthetic_pool(args.seconds, args.seed, vocab, pool=args.pool,
                              noise_pool=args.noise_pool, max_label=args.max_label)
        logger.info("pool: %d clips, %d noise (%.1fs)", len(pool["speech"]),
                    len(pool["noise"]), time.time() - t0)

    os.makedirs(args.output_dir, exist_ok=True)
    cfg = asr_model.ASRModelConfig(vocab_size=len(vocab) + 1)
    params = asr_model.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    logger.info("vocab %d, params %.2fM", len(vocab), n_params / 1e6)
    opt = optimizer(args.learning_rate, args.max_steps)
    state = init_state(params, opt)

    def loss_fn(p, b):
        loss, emit = asr_model.ctc_loss(p, cfg, b["wavs"], b["wav_len"], b["labels"],
                                        b["label_len"])
        return loss, {"emit_frac": emit}

    def step(batch):
        nonlocal state
        state, metrics = loss_train_step(state, batch, loss_fn, opt)
        if on_step is not None:
            on_step(state, metrics)
        return metrics

    def log(done, metrics):
        logger.info("step %d loss %.4f emit-frac %.3f (%.1fs)", done,
                    float(metrics["loss"]), float(metrics["emit_frac"]), time.time() - t0)

    t0 = time.time()
    if pool is not None:
        draw = DeviceBatches(pool, args.batch_size, args.seconds, device,
                             torch.Generator(device=device).manual_seed(args.seed + 1))
        chunk = max(1, min(args.logging_steps, args.max_steps))
        for i in range(args.max_steps):
            metrics = step(draw())
            if (i + 1) % chunk == 0 or i + 1 == args.max_steps:
                log(i + 1, metrics)
    else:
        with Prefetch(gen) as prefetch:
            batches = iter(prefetch)
            for i in range(args.max_steps):
                wavs, wav_len, labels, label_len = next(batches)
                metrics = step(batch_to({"wavs": wavs, "wav_len": wav_len, "labels": labels,
                                         "label_len": label_len}, device))
                if (i + 1) % args.logging_steps == 0 or i == 0:
                    log(i + 1, metrics)

    out = os.path.join(args.output_dir, "asr.npz")
    asr_model.save_ckpt(out, {k: p.detach().half() for k, p in tree_leaves(state.params)},
                        cfg, vocab)
    logger.info("done: %s", out)
    return state


if __name__ == "__main__":
    main()
