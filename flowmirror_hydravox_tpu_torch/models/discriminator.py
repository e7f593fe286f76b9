"""GAN discriminators for vocoder training: port of
flowmirror_hydravox_tpu/models/discriminator.py.

  - MPD: multi-period discriminators (periods 2, 3, 5, 7, 11), 2D convs over
    the waveform reshaped to (T/p, p).
  - Multi-resolution spectrogram discriminator: 2D convs over |STFT| at three
    resolutions (n_fft, hop, win) = (1024, 120, 600), (2048, 240, 1200),
    (512, 50, 240).

Weights are the JAX package's tree (`params.init_disc_params` draws one):
conv weights OIHW, which is `F.conv2d`'s layout, so they carry over as they
are. Every padding here is symmetric, so each conv takes its (H, W) padding
as two ints.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..utils.audio import hann_window, reflect_pad

PERIODS = (2, 3, 5, 7, 11)
SPEC_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def conv2d(p, x, stride=(1, 1), padding=(0, 0)):
    """NCHW conv with OIHW weights; `padding` (h, w) on both sides."""
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# MPD


def _mpd_one(p, x, period: int):
    """x: (B, 1, T). Returns (score (B, n), fmaps)."""
    b, c, t = x.shape
    pad = (-t) % period
    if pad:
        x = F.pad(x, (0, pad), mode="reflect")
    x = x.reshape(b, c, (t + pad) // period, period)
    fmaps = []
    last = len(p["convs"]) - 1
    for i, conv in enumerate(p["convs"]):
        x = F.leaky_relu(conv2d(conv, x, stride=(3, 1) if i < last else (1, 1),
                                padding=(2, 0)), 0.1)
        fmaps.append(x)
    x = conv2d(p["post"], x, padding=(1, 0))
    fmaps.append(x)
    return x.reshape(b, -1), fmaps


# ---------------------------------------------------------------------------
# multi-resolution spectrogram discriminator


def _stft_mag(x, n_fft: int, hop: int, win: int):
    """|STFT| (B, frames, n_fft//2 + 1) of x (B, T), as the JAX function takes
    it: frames of `win` samples from the signal reflect-padded by n_fft // 2,
    a Hann window of `win`, zeros after the frame up to n_fft, and
    sqrt(max(re^2 + im^2, 1e-9)). (`torch.stft` would centre a short window
    in its frame, and `utils.audio.stft_magnitude` adds 1e-9 instead of
    clamping: both give other values.)"""
    t = x.shape[-1]
    window = torch.from_numpy(hann_window(win)).to(x.device)
    frames = reflect_pad(x, n_fft // 2).unfold(-1, win, hop)[:, : t // hop + 1] * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return torch.sqrt(torch.clamp_min(spec.real ** 2 + spec.imag ** 2, 1e-9))


_MRD_STRIDES = ((1, 1), (1, 2), (1, 2), (1, 2), (1, 1))
_MRD_PADS = ((1, 4),) * 4 + ((1, 1),)


def _mrd_one(p, x, n_fft: int, hop: int, win: int):
    """x: (B, 1, T). Returns (score (B, n), fmaps)."""
    h = _stft_mag(x[:, 0], n_fft, hop, win)[:, None]  # (B, 1, frames, freq)
    fmaps = []
    for conv, s, pd in zip(p["convs"], _MRD_STRIDES, _MRD_PADS):
        h = F.leaky_relu(conv2d(conv, h, stride=s, padding=pd), 0.1)
        fmaps.append(h)
    h = conv2d(p["post"], h, padding=(1, 1))
    fmaps.append(h)
    return h.reshape(h.shape[0], -1), fmaps


# ---------------------------------------------------------------------------
# combined


def forward(params: dict, wav) -> Tuple[List[torch.Tensor], List[list]]:
    """wav (B, T). Returns (the 8 sub-discriminators' scores, their feature
    maps), the 5 MPDs first."""
    x = wav[:, None, :]
    scores, fmaps = [], []
    for p, period in zip(params["mpd"], PERIODS):
        s, f = _mpd_one(p, x, period)
        scores.append(s)
        fmaps.append(f)
    for p, (n_fft, hop, win) in zip(params["mrd"], SPEC_RESOLUTIONS):
        s, f = _mrd_one(p, x, n_fft, hop, win)
        scores.append(s)
        fmaps.append(f)
    return scores, fmaps
