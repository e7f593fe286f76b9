# Copied from flowmirror_hydravox_tpu/train/augment.py (numpy; the same bytes for the same seed).
"""Recording-channel augmentation for frontend-extractor training
(train/train_frontend.py --augment).

The shipped speaker encoder is trained on the clean formant corpus
(train/synth_speech.py). Real recordings differ from it mainly by channel
effects: room reverberation, recording noise, band-limiting, spectral tilt
and level. Applied as label-preserving augmentations, they make the
embedding invariant to the channel (the x-vector / CAM++ recipe, reference
extractor role campplus.onnx, cli/frontend.py:105-116).

All transforms are numpy, seeded, and label-preserving (they never change
who is speaking):
  - additive noise (white/pink) at a random SNR;
  - synthetic room IR: exponentially-decaying noise tail, random RT and
    direct-to-reverb ratio (the standard image-method stand-in);
  - channel EQ: random first-order spectral tilt plus random high-pass /
    low-pass corner frequencies (telephone/laptop-mic band-limiting);
  - level: random gain and occasional soft clipping.
"""

from __future__ import annotations

import numpy as np

SR = 16000


def _pink_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    """1/f-shaped noise via FFT weighting (cheap, good enough for SNR aug)."""
    spec = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(n // 2 + 1)
    f = np.maximum(np.fft.rfftfreq(n, 1.0 / SR), 1.0)
    out = np.fft.irfft(spec / np.sqrt(f), n)
    return (out / (np.std(out) + 1e-9)).astype(np.float32)


def _room_ir(rng: np.random.Generator) -> np.ndarray:
    """Exponential-decay noise IR: direct impulse + decaying tail."""
    rt60 = float(rng.uniform(0.05, 0.4))  # seconds
    n = int(rt60 * SR)
    t = np.arange(n) / SR
    tail = rng.standard_normal(n) * np.exp(-6.9 * t / rt60)  # -60 dB at rt60
    drr = float(rng.uniform(1.0, 6.0))  # direct-to-reverb amplitude ratio
    ir = np.concatenate([[drr], tail * 0.5]).astype(np.float32)
    return ir / (np.sqrt(np.sum(ir**2)) + 1e-9)


def _eq(rng: np.random.Generator, wav: np.ndarray) -> np.ndarray:
    """Random tilt + band-limiting in the frequency domain."""
    n = len(wav)
    spec = np.fft.rfft(wav)
    f = np.fft.rfftfreq(n, 1.0 / SR)
    # tilt: +/- 6 dB per decade around 1 kHz
    tilt_db = float(rng.uniform(-6.0, 6.0))
    gain = 10.0 ** (tilt_db * np.log10(np.maximum(f, 50.0) / 1000.0) / 20.0)
    # band-limits: high-pass 50-300 Hz, low-pass 3.4-8 kHz (1st order)
    f_hp = float(rng.uniform(50.0, 300.0))
    f_lp = float(rng.uniform(3400.0, 8000.0))
    gain = gain / np.sqrt(1.0 + (f_hp / np.maximum(f, 1.0)) ** 2)
    gain = gain / np.sqrt(1.0 + (f / f_lp) ** 2)
    return np.fft.irfft(spec * gain, n).astype(np.float32)


def augment_wav(rng: np.random.Generator, wav: np.ndarray) -> np.ndarray:
    """One random channel realization of `wav` (float32 mono 16 kHz)."""
    out = wav.astype(np.float32)
    # reverb (70%) — FFT convolution: direct np.convolve is O(n*m) and the
    # IR reaches 6400 taps (0.4 s RT), far too slow inside a data loader
    if rng.random() < 0.7:
        ir = _room_ir(rng)
        n_fft = int(2 ** np.ceil(np.log2(len(out) + len(ir) - 1)))
        out = np.fft.irfft(
            np.fft.rfft(out, n_fft) * np.fft.rfft(ir, n_fft), n_fft
        )[: len(wav)].astype(np.float32)
    # EQ / band-limiting (80%)
    if rng.random() < 0.8:
        out = _eq(rng, out)
    # additive noise (85%)
    if rng.random() < 0.85:
        snr_db = float(rng.uniform(5.0, 30.0))
        noise = (_pink_noise(rng, len(out)) if rng.random() < 0.5
                 else rng.standard_normal(len(out)).astype(np.float32))
        sig_p = np.mean(out**2) + 1e-9
        noise_p = np.mean(noise**2) + 1e-9
        scale = np.sqrt(sig_p / (noise_p * 10.0 ** (snr_db / 10.0)))
        out = out + scale * noise
    # level + occasional soft clip
    out = out * float(rng.uniform(0.3, 1.2))
    if rng.random() < 0.2:
        out = np.tanh(out * 2.0) / 2.0
    peak = np.max(np.abs(out)) + 1e-9
    if peak > 0.99:
        out = out * (0.99 / peak)
    return out.astype(np.float32)


def augment_batches(batches, seed: int = 0, prob: float = 0.5):
    """Wrap a (wavs, labels) generator with per-crop channel augmentation.

    `prob` < 1 keeps a clean view of some crops in every batch: training on
    augmented views ONLY makes the embedding channel-invariant but collapses
    between-speaker spread (measured on the real-speech eval: gap 0.249 ->
    0.187 at prob 1.0); mixing clean and augmented views keeps the clean
    manifold anchored while still teaching channel invariance."""
    rng = np.random.default_rng(seed + 777)
    for wavs, labels in batches:
        aug = np.stack([
            augment_wav(rng, w) if rng.random() < prob else w for w in wavs
        ])
        yield aug, labels
