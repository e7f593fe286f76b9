"""The native VAD's forward (port of flowmirror_hydravox_tpu/preprocess/vad_model.py):
the Silero-role frame classifier of stage 2, ~30k parameters of dilated
convs over a 40-bin log-mel (25 ms window, 10 ms hop at 16 kHz).

Per clip: the log-mel is normalised to zero mean and unit variance per bin,
then five dilated 3-tap convs with ReLU (dilations 1, 2, 4, 8, 16; a
receptive field of about 620 ms, non-causal) and a 1x1 out conv give one
speech logit per 10 ms frame. The whole clip is one forward on the device.

`NativeVAD` loads the shipped weights, `assets/vad.npz` (a byte-identical
copy of the JAX package's, stored fp16 and run in f32 as JAX's template
casts them), or `path` / HYDRAVOX_VAD_NPZ, and raises FileNotFoundError when
none exist. `maybe_native_vad` turns only that error into None (the energy
VAD's fallback): any other error raises, where the JAX helper swallows every
exception (vad_model.py:134-139) and would hide a fault of the device.

`init_params` (He-normal convs from a `torch.Generator`, zero biases) and
`bce_loss` serve the VAD trainer (train/train_vad.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..params import _Init, flatten_params, load_params_npz
from ..utils.audio import mel_spectrogram, resample_linear

SR = 16000

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "vad.npz")


@dataclasses.dataclass(frozen=True)
class VADModelConfig:
    n_mels: int = 40
    channels: int = 48
    dilations: Tuple[int, ...] = (1, 2, 4, 8, 16)


def expected_keys(cfg: VADModelConfig) -> set:
    return ({f"convs.{i}.{k}" for i in range(len(cfg.dilations)) for k in "wb"}
            | {"out.w", "out.b"})


def init_params(cfg: VADModelConfig, generator: torch.Generator, device="cpu",
                dtype=torch.float32) -> dict:
    """He-normal convs (std sqrt(2 / fan_in), fan_in = in_ch x k) and zero
    biases, at the JAX init's shapes (vad_model.py:37)."""
    ini, convs, ch_in = _Init(generator, device, dtype), [], cfg.n_mels
    for _ in cfg.dilations:
        convs.append({"w": ini.normal(cfg.channels, ch_in, 3, std=(2.0 / (ch_in * 3)) ** 0.5),
                      "b": ini.zeros(cfg.channels)})
        ch_in = cfg.channels
    return {"convs": convs,
            "out": {"w": ini.normal(1, cfg.channels, 1, std=(2.0 / cfg.channels) ** 0.5),
                    "b": ini.zeros(1)}}


def frame_logits(params: dict, cfg: VADModelConfig, wav_16k: torch.Tensor) -> torch.Tensor:
    """wav (B, T) float32 at 16 kHz -> per-frame speech logits (B, n_frames)."""
    mel = mel_spectrogram(wav_16k, 400, cfg.n_mels, SR, 160, 400)  # (B, M, F)
    mu = mel.mean(dim=-1, keepdim=True)
    sd = torch.sqrt(mel.var(dim=-1, unbiased=False, keepdim=True) + 1e-5)
    x = (mel - mu) / sd
    for conv, d in zip(params["convs"], cfg.dilations):
        x = F.relu(F.conv1d(x, conv["w"], conv["b"], padding=d, dilation=d))
    return F.conv1d(x, params["out"]["w"], params["out"]["b"])[:, 0, :]


def bce_loss(params: dict, cfg: VADModelConfig, wavs, frame_labels):
    """(mean BCE over frames, frame accuracy); labels (B, F) in {0, 1} on the
    10 ms hop grid, both truncated to the shorter of the two."""
    logits = frame_logits(params, cfg, wavs)
    f = min(logits.shape[1], frame_labels.shape[1])
    logits, labels = logits[:, :f], frame_labels[:, :f].to(torch.float32)
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    acc = ((logits > 0) == (labels > 0.5)).to(torch.float32).mean()
    return loss, acc


class NativeVAD:
    """A trained `speech_prob_fn` for `vad.detect_speech`: `(wav, sr)` ->
    per-frame speech probabilities (numpy), computed on `device`."""

    def __init__(self, path: Optional[str] = None, device="cuda"):
        path = path or os.environ.get("HYDRAVOX_VAD_NPZ") or _ASSET
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.device = resolve_device(device)
        self.cfg = VADModelConfig()
        self.params = load_params_npz(path, self.device, torch.float32)
        missing = expected_keys(self.cfg) - set(flatten_params(self.params))
        if missing:
            raise KeyError(f"{path} lacks {sorted(missing)}")

    @torch.inference_mode()
    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(wav, np.float32).reshape(-1)))
        x = resample_linear(x.to(self.device)[None], sr, SR)
        return torch.sigmoid(frame_logits(self.params, self.cfg, x))[0].cpu().numpy()


def maybe_native_vad(path: Optional[str] = None, device="cuda") -> Optional[NativeVAD]:
    """NativeVAD when its weights exist, else None (the energy fallback)."""
    try:
        return NativeVAD(path, device)
    except FileNotFoundError:
        return None
