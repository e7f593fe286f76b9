# Copied from flowmirror_hydravox_tpu/utils/audio.py (the numpy filterbank and
# window helpers); the framing, STFT and mel functions are its torch port.
"""Audio featurisation on torch tensors.

  - `mel_filterbank`: the Slaney-scale triangular filterbank of
    `librosa.filters.mel` (numpy, cached).
  - `mel_spectrogram`: the 24 kHz 80-bin log-mel (n_fft 1920, hop 480, win
    1920, reflect padding, center=False, log-clamp 1e-5) fed to the flow, and
    at 16 kHz (n_fft 400, hop 160) to the speaker encoder.
  - `whisper_log_mel`: the 128-bin 16 kHz whisper log-mel fed to the speech
    tokenizer.
  - `kaldi_fbank`: the kaldi-style 80-bin fbank the speaker encoder trains
    on (HTK mel banks, `mel_filterbank(..., htk=True)`), batched over
    leading axes.
  - `resample_linear`: the frontend's linear-interpolation resampler.

Each runs on the device of its input. Reflect padding follows numpy's
(`jnp.pad(mode="reflect")`), which also pads past the signal's own length by
reflecting again; `torch.nn.functional.pad` refuses that.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None,
    htk: bool = False,
) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, n_fft//2 + 1).

    htk=False: Slaney scale + normalization, matching
    librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) defaults.
    htk=True: HTK mel scale, unnormalized (kaldi-fbank style).
    """
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    if htk:
        def to_mel(f):
            return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

        def to_hz(m):
            return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)

        mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
        hz_pts = to_hz(mel_pts)
    else:
        mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
        hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if not htk:
        # Slaney normalization: scale each filter to ~constant energy per channel.
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def hann_window(win_size: int, periodic: bool = True) -> np.ndarray:
    """torch.hann_window equivalent (periodic=True by default)."""
    n = win_size if periodic else win_size - 1
    k = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last axis by `pad` on each side as numpy's reflect mode does,
    for any pad: past the signal's length the reflection repeats with period
    2 (T - 1)."""
    t = y.shape[-1]
    if pad == 0:
        return y
    if t == 1:
        return y.expand(*y.shape[:-1], 1 + 2 * pad)
    period = 2 * (t - 1)
    idx = torch.remainder(torch.arange(-pad, t + pad, device=y.device), period)
    idx = torch.where(idx >= t, period - idx, idx)
    return y[..., idx]


def frame_signal(y: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_len), n_frames = 1 + (T - frame_len) // hop."""
    n_frames = max(1 + (y.shape[-1] - frame_len) // hop, 0)
    if n_frames == 0:
        return y.new_zeros(*y.shape[:-1], 0, frame_len)
    return y.unfold(-1, frame_len, hop)[..., :n_frames, :]


def _window(win_size: int, device) -> torch.Tensor:
    return torch.from_numpy(hann_window(win_size)).to(device)


def _filterbank(sr: int, n_fft: int, n_mels: int, device, fmin: float = 0.0,
                fmax: Optional[float] = None, htk: bool = False) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk)).to(device)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_size: int,
                   window: torch.Tensor) -> torch.Tensor:
    """|STFT| of (..., T) -> (..., n_freqs, n_frames). Assumes pre-padded
    input, center=False."""
    frames = frame_signal(y, win_size, hop) * window
    if frames.shape[-2] == 0:  # a clip shorter than one window (MKL's FFT refuses no rows)
        return frames.new_zeros(*frames.shape[:-2], n_fft // 2 + 1, 0)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)  # zero-pads win_size < n_fft
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.transpose(-1, -2)


def mel_spectrogram(
    y: torch.Tensor,
    n_fft: int = 1920,
    num_mels: int = 80,
    sampling_rate: int = 24000,
    hop_size: int = 480,
    win_size: int = 1920,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> torch.Tensor:
    """Log-mel of the reference (scripts/preprocess/audio.py:45-82).

    y: (B, T) float waveform in [-1, 1]. Returns (B, num_mels, n_frames)."""
    y = reflect_pad(y, (n_fft - hop_size) // 2)
    mag = stft_magnitude(y, n_fft, hop_size, win_size, _window(win_size, y.device))
    mel = _filterbank(sampling_rate, n_fft, num_mels, y.device, fmin, fmax) @ mag
    return torch.log(torch.clamp(mel, min=1e-5))


def whisper_log_mel(y: torch.Tensor, n_mels: int = 128, sample_rate: int = 16000) -> torch.Tensor:
    """Whisper-style log-mel (n_fft 400, hop 160, centered reflect padding)
    feeding the speech tokenizer (reference cli/frontend.py:92-104).

    y: (B, T) 16 kHz waveform. Returns (B, n_mels, T // 160)."""
    n_fft, hop = 400, 160
    n_keep = y.shape[-1] // hop  # whisper drops the last frame
    frames = frame_signal(reflect_pad(y, n_fft // 2), n_fft, hop)[..., :n_keep, :]
    spec = torch.fft.rfft(frames * _window(n_fft, y.device), n=n_fft, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(-1, -2)
    mel = _filterbank(sample_rate, n_fft, n_mels, y.device) @ power
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def kaldi_fbank(y: torch.Tensor, sample_rate: int = 16000, num_mels: int = 80) -> torch.Tensor:
    """Kaldi-style log-mel fbank (the campplus features, reference
    cli/frontend.py:105-116): 25 ms / 10 ms snip-edge frames at the int16
    scale, DC removal, the povey window, n_fft 512, HTK mel banks from 20 Hz;
    no dither, as the JAX function.

    y: (..., T) 16 kHz waveform in [-1, 1], each leading row a clip (the JAX
    function takes one clip and is vmapped). Returns (..., n_frames, num_mels),
    n_frames = max(1 + (T - 400) // 160, 1); a clip shorter than one frame
    repeats its last sample."""
    frame_len = int(sample_rate * 0.025)
    hop = int(sample_rate * 0.010)
    y = y.to(torch.float32) * 32768.0  # kaldi int16 scale
    t = y.shape[-1]
    n_frames = max(1 + (t - frame_len) // hop, 1)
    idx = (torch.arange(n_frames, device=y.device)[:, None] * hop
           + torch.arange(frame_len, device=y.device)[None, :])
    frames = y[..., idx.clamp(max=t - 1)]
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove_dc
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))
    povey = torch.from_numpy((hann ** 0.85).astype(np.float32)).to(y.device)
    n_fft = 1 << (frame_len - 1).bit_length()
    spec = torch.fft.rfft(frames * povey, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ _filterbank(sample_rate, n_fft, num_mels, y.device, fmin=20.0, htk=True).T
    return torch.log(torch.clamp(mel, min=1e-10))


def resample_linear(y: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Linear-interpolation resampler for frontend prompts. The source
    positions are f32 products, as the JAX function computes them, so the
    interpolation weights agree to the bit at any length."""
    if orig_sr == target_sr:
        return y
    t = y.shape[-1]
    n_out = int(round(t * target_sr / orig_sr))
    step = torch.tensor(orig_sr / target_sr, dtype=torch.float32, device=y.device)
    src_pos = torch.arange(n_out, dtype=torch.float32, device=y.device) * step
    lo = torch.clamp(torch.floor(src_pos).to(torch.int64), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    w = (src_pos - lo.to(torch.float32)).to(y.dtype)
    return y[..., lo] * (1 - w) + y[..., hi] * w
