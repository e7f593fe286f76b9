# Copied from flowmirror_hydravox_tpu/train/synth_speech.py (pure numpy).
"""Deterministic multi-speaker synthetic-speech corpus (formant synthesis).

The reference's frontend extractors (speech_tokenizer_v3.onnx / campplus.onnx,
cli/frontend.py:54-57,92-116) ship as frozen weights that are absent from this
snapshot, and this image has no audio corpus and no network egress.  To make
the native stand-in extractors (frontend/speech_tokenizer.py) produce
*non-noise* conditioning we train them on audio that has the statistical
structure the extractors must key on:

  - a SPEAKER identity = stable vocal-tract + glottal parameters
    (formant frequencies F1-F4, f0 register, spectral tilt, breathiness,
    speaking rate) — what a speaker-verification embedding must capture;
  - CONTENT = a sequence of phoneme-like segments (vowels with distinct
    formant targets, fricative noise bursts, plosive gaps) — what a
    supervised/self-supervised speech tokenizer must track frame by frame.

The synthesis is harmonic-plus-noise: voiced segments are harmonic stacks
whose per-harmonic amplitude follows a formant envelope (Gaussian resonances
at the speaker x vowel formant targets over a tilted base), with f0
declination, vibrato and jitter; unvoiced segments are FFT-shaped noise.
Everything is seeded: (speaker_id, utterance_id) -> identical waveform on
every machine, so trained checkpoints are reproducible from the recipe.

This is training DATA synthesis, not TTS: quality only needs to be good
enough that "two prompt speakers differ measurably and tokens track content",
which is the property the zero-shot pipeline needs from the extractors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

SR = 16000

# Vowel formant targets (Hz), loosely the Peterson-Barney vowel space.
# Speaker-specific vocal-tract length scales these.
_VOWELS = np.array([
    # F1    F2    F3
    [730, 1090, 2440],   # /a/
    [270, 2290, 3010],   # /i/
    [300, 870, 2240],    # /u/
    [530, 1840, 2480],   # /e/
    [570, 840, 2410],    # /o/
    [660, 1720, 2410],   # /ae/
    [440, 1020, 2240],   # /er/
    [490, 1350, 1690],   # /r-colored/
], np.float64)

# Fricative noise bands (low, high) Hz.
_FRICS = np.array([
    [2500, 7500],  # /s/-like
    [1000, 4000],  # /sh/-like
    [4000, 7900],  # /f/-like
    [500, 2500],   # /h/-like
], np.float64)


@dataclasses.dataclass(frozen=True)
class SpeakerProfile:
    """Stable per-speaker parameters; the identity the embedding must learn."""
    f0_base: float          # median f0, Hz
    f0_range: float         # log-f0 excursion scale
    vtl_scale: float        # vocal-tract length factor (scales formants)
    tilt_db_oct: float      # spectral tilt of the source, dB/octave
    bandwidth_scale: float  # formant bandwidth factor
    breathiness: float      # aspiration-noise mix in voiced segments
    rate: float             # segments per second
    vibrato_hz: float
    vibrato_depth: float    # semitones


def speaker_profile(speaker_id: int, seed: int = 0) -> SpeakerProfile:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA5, speaker_id]))
    return SpeakerProfile(
        f0_base=float(np.exp(rng.uniform(np.log(85.0), np.log(280.0)))),
        f0_range=float(rng.uniform(0.08, 0.25)),
        vtl_scale=float(rng.uniform(0.82, 1.22)),
        tilt_db_oct=float(rng.uniform(-15.0, -5.0)),
        bandwidth_scale=float(rng.uniform(0.7, 1.5)),
        breathiness=float(rng.uniform(0.01, 0.12)),
        rate=float(rng.uniform(4.0, 9.0)),
        vibrato_hz=float(rng.uniform(4.0, 6.5)),
        vibrato_depth=float(rng.uniform(0.05, 0.5)),
    )


def _formant_envelope(freqs: np.ndarray, formants: np.ndarray,
                      bws: np.ndarray, tilt_db_oct: float) -> np.ndarray:
    """Amplitude (linear) at `freqs` from Gaussian resonances + source tilt."""
    env = np.zeros_like(freqs)
    for f, bw in zip(formants, bws):
        env += np.exp(-0.5 * ((freqs - f) / bw) ** 2)
    tilt = 10.0 ** (tilt_db_oct * np.log2(np.maximum(freqs, 1.0) / 100.0) / 20.0)
    return (0.05 + env) * tilt


def _voiced_segment(rng: np.random.Generator, prof: SpeakerProfile,
                    vowel: int, n: int, f0_mul: float) -> np.ndarray:
    """Harmonic stack with formant envelope, vibrato, jitter, declination."""
    t = np.arange(n) / SR
    f0 = prof.f0_base * f0_mul
    # declination + vibrato + jitter (slow random walk)
    contour = f0 * (
        2.0 ** (-0.06 * t / max(t[-1], 1e-3))
        * 2.0 ** (prof.vibrato_depth / 12.0 * np.sin(2 * np.pi * prof.vibrato_hz * t))
    )
    jitter = np.cumsum(rng.standard_normal(n)) * (0.002 / np.sqrt(SR))
    contour = contour * np.exp(jitter - jitter.mean())
    phase0 = np.cumsum(contour) * (2 * np.pi / SR)

    formants = _VOWELS[vowel] / prof.vtl_scale
    # F4 fixed high resonance, scaled by VTL
    formants = np.append(formants, 3400.0 / prof.vtl_scale)
    bws = np.array([80.0, 120.0, 160.0, 220.0]) * prof.bandwidth_scale

    n_harm = max(int(7600.0 / (contour.max() + 1e-6)), 1)
    n_harm = min(n_harm, 80)
    k = np.arange(1, n_harm + 1)[:, None]           # (H, 1)
    hfreq = k * contour[None, :].mean()             # envelope at mean f0 per harmonic
    amps = _formant_envelope(hfreq[:, 0], formants, bws, prof.tilt_db_oct)
    # drop harmonics above Nyquist guard dynamically (mean-based; contour
    # excursion is small)
    amps = np.where(hfreq[:, 0] < 7800.0, amps, 0.0)
    wav = (amps[:, None] * np.sin(k * phase0[None, :])).sum(axis=0)
    wav /= max(np.abs(wav).max(), 1e-6)
    if prof.breathiness > 0:
        noise = rng.standard_normal(n)
        spec = np.fft.rfft(noise)
        fr = np.fft.rfftfreq(n, 1.0 / SR)
        spec *= _formant_envelope(fr, formants, bws * 2.0, prof.tilt_db_oct)
        noise = np.fft.irfft(spec, n)
        noise /= max(np.abs(noise).max(), 1e-6)
        wav = (1 - prof.breathiness) * wav + prof.breathiness * noise
    return wav


def _fricative_segment(rng: np.random.Generator, prof: SpeakerProfile,
                       fric: int, n: int) -> np.ndarray:
    lo, hi = _FRICS[fric] / prof.vtl_scale
    noise = rng.standard_normal(n)
    spec = np.fft.rfft(noise)
    fr = np.fft.rfftfreq(n, 1.0 / SR)
    band = np.exp(-0.5 * ((fr - (lo + hi) / 2) / ((hi - lo) / 3)) ** 2)
    out = np.fft.irfft(spec * band, n)
    return 0.4 * out / max(np.abs(out).max(), 1e-6)


# Phoneme-like segment symbols, indexed like _VOWELS / _FRICS rows — the
# transcription alphabet for the native CTC ASR (preprocess/asr_model.py).
VOWEL_SYMBOLS = ("a", "i", "u", "e", "o", "E", "R", "r")
FRIC_SYMBOLS = ("s", "S", "f", "h")


def _synth(speaker_id: int, utterance_id: int, seconds: float, seed: int):
    """(wav float32, per-sample speech mask uint8, segment symbol list).

    The single seeded synthesis path: every rng draw happens in the same
    order regardless of which wrapper asked, so adding the segment record
    did not change any previously-shipped waveform (trained VAD / frontend
    checkpoints stay reproducible from their recipes)."""
    prof = speaker_profile(speaker_id, seed)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 0x5E, speaker_id, utterance_id]))
    total = int(seconds * SR)
    out = np.zeros(total, np.float64)
    mask = np.zeros(total, np.uint8)
    segments: List[str] = []
    pos = 0
    while pos < total:
        dur = rng.uniform(0.6, 1.6) / prof.rate
        n = min(int(dur * SR), total - pos)
        if n < 64:
            break
        kind = rng.random()
        speech = True
        if kind < 0.62:  # vowel
            vowel = int(rng.integers(len(_VOWELS)))
            seg = _voiced_segment(rng, prof, vowel, n,
                                  f0_mul=float(np.exp(rng.normal(0, prof.f0_range))))
            segments.append(VOWEL_SYMBOLS[vowel])
        elif kind < 0.82:  # fricative
            fric = int(rng.integers(len(_FRICS)))
            seg = _fricative_segment(rng, prof, fric, n)
            segments.append(FRIC_SYMBOLS[fric])
        else:  # pause / plosive gap
            seg = np.zeros(n)
            speech = False
        # 10 ms raised-cosine edges to avoid clicks
        edge = min(int(0.010 * SR), n // 2)
        if edge > 0:
            win = 0.5 * (1 - np.cos(np.pi * np.arange(edge) / edge))
            seg[:edge] *= win
            seg[-edge:] *= win[::-1]
        out[pos:pos + n] += seg * rng.uniform(0.5, 1.0)
        if speech:
            mask[pos:pos + n] = 1
        pos += n
    out *= 0.6 / max(np.abs(out).max(), 1e-6)
    return out.astype(np.float32), mask, segments


def synth_utterance_with_mask(speaker_id: int, utterance_id: int,
                              seconds: float = 4.0, seed: int = 0):
    """Like synth_utterance but also returns the per-sample speech/silence
    ground truth (uint8) — the supervision signal for VAD training."""
    wav, mask, _ = _synth(speaker_id, utterance_id, seconds, seed)
    return wav, mask


def synth_utterance_with_segments(speaker_id: int, utterance_id: int,
                                  seconds: float = 4.0, seed: int = 0):
    """Like synth_utterance but also returns the ordered phoneme-like segment
    symbols (pauses excluded) — the transcription ground truth for CTC ASR
    training (train/train_asr.py)."""
    wav, _, segments = _synth(speaker_id, utterance_id, seconds, seed)
    return wav, segments


def synth_utterance(speaker_id: int, utterance_id: int, seconds: float = 4.0,
                    seed: int = 0) -> np.ndarray:
    """Deterministic (speaker, utterance) -> float32 mono waveform at 16 kHz."""
    return synth_utterance_with_mask(speaker_id, utterance_id, seconds, seed)[0]


def synth_noise(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """Non-speech interference for VAD training: white / pink (1/f) /
    hum (mains harmonics) / babble (overlapped distant speakers)."""
    if kind == "white":
        out = rng.standard_normal(n)
    elif kind == "pink":
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.maximum(np.fft.rfftfreq(n, 1.0 / SR), 1.0)
        out = np.fft.irfft(spec / np.sqrt(f), n)
    elif kind == "hum":
        t = np.arange(n) / SR
        out = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * 50.0 * k * t +
                                                 rng.uniform(0, 2 * np.pi))
                  for k in range(1, 6))
        out = np.asarray(out) + 0.05 * rng.standard_normal(n)
    elif kind == "babble":
        # several faraway "speakers" summed — the hardest case for energy VAD
        out = np.zeros(n)
        for _ in range(6):
            spk = int(rng.integers(0, 1 << 20))
            utt = int(rng.integers(0, 1 << 20))
            w = synth_utterance(spk, utt, n / SR + 0.1, seed=int(rng.integers(1 << 16)))
            out += w[:n]
    else:
        raise ValueError(kind)
    return (out / max(np.abs(out).max(), 1e-6)).astype(np.float32)


def synth_batches(batch_size: int, seconds: float, n_speakers: int, seed: int):
    """Endless (wavs (B,T), speaker_labels (B,)) batches, deterministic in
    (seed, batch index). Utterance ids never repeat across batches."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBA7C]))
    utt = 0
    while True:
        spk = rng.integers(0, n_speakers, batch_size)
        wavs = np.stack([
            synth_utterance(int(s), utt + i, seconds, seed) for i, s in enumerate(spk)
        ])
        utt += batch_size
        yield wavs, spk.astype(np.int32)


def synth_corpus(n_utts: int, n_speakers: int, utt_seconds: float, seed: int,
                 workers: int = 8):
    """Pre-generate a finite speaker-balanced corpus in parallel (the numpy
    FFT/ufunc kernels release the GIL, so threads scale).  Returns
    (wavs (N, T) float32, speaker_labels (N,))."""
    from concurrent.futures import ThreadPoolExecutor

    spk = np.arange(n_utts) % n_speakers
    with ThreadPoolExecutor(workers) as ex:
        wavs = list(ex.map(
            lambda i: synth_utterance(int(spk[i]), i, utt_seconds, seed),
            range(n_utts)))
    return np.stack(wavs), spk.astype(np.int32)


def corpus_batches(batch_size: int, seconds: float, n_speakers: int, seed: int,
                   corpus_utts: int = 1024, utt_seconds: float = 6.0):
    """Endless batches of random fixed-length crops from a cached synthetic
    corpus — the data path for real (multi-thousand-step) training runs,
    where per-batch streaming synthesis would bottleneck the device."""
    wavs, spk = synth_corpus(corpus_utts, n_speakers, utt_seconds, seed)
    n = int(seconds * SR)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC0]))
    max_start = max(wavs.shape[1] - n, 1)
    while True:
        idx = rng.integers(0, len(wavs), batch_size)
        starts = rng.integers(0, max_start, batch_size)
        batch = np.stack([wavs[i, s:s + n] for i, s in zip(idx, starts)])
        yield batch, spk[idx]
