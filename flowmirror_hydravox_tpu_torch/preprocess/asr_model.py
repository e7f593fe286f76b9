"""The native CTC ASR's forward (port of flowmirror_hydravox_tpu/preprocess/asr_model.py):
stage 3's in-repo recognizer, a conformer-lite over an 80-bin log-mel.

  - Features: the 16 kHz log-mel (n_fft 400, hop 160), normalised per clip
    over its valid frames only, padded frames zeroed, so that no logit
    depends on the samples past a clip's length (`NativeASR` pads clips to a
    power of two).
  - 4x frame stacking (a reshape) to one frame per 40 ms, a projection to
    d_model and sinusoidal positions.
  - Blocks: LN -> MHSA (padded keys biased by -1e9) -> residual; LN ->
    pointwise GLU -> depthwise conv (k 9, padded frames zeroed first) ->
    SiLU -> pointwise -> residual; LN -> FFN (4d, SiLU) -> residual.
  - A final LN and the vocabulary head; greedy CTC decoding (blank 0) on the
    host.

`NativeASR` is a `fn(wav, sr) -> str` callable, the transcribe stage's
`--asr_module` contract (`--asr_module native` resolves to it). It loads
`assets/asr.npz`, a byte-identical copy of the JAX package's (fp16, run in
f32), or `path` / HYDRAVOX_ASR_NPZ, and runs on `device`.

`init_params` (scaled-normal matrices from a `torch.Generator`) and
`ctc_loss` serve the ASR trainer (train/train_asr.py). The JAX loss is
`optax.ctc_loss`; here it is `torch.nn.functional.ctc_loss` (blank 0) on
the log-softmax, with each row's frames from its padding. One difference:
a row that no path can emit (more labels than its frames allow) adds 0 to
the loss and no gradient (`zero_infinity`), where optax clamps the path's
log-probability at log_epsilon (-1e5) and adds about 1e5 / label_len.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..params import _Init, flatten_params, from_numpy_tree, unflatten_params
from ..utils.audio import mel_spectrogram, resample_linear

SR = 16000
HOP = 160          # 10 ms mel hop
SUBSAMPLE = 4      # frame stacking factor: one logit per 40 ms

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "asr.npz")
_LAYER_KEYS = ("wq", "wk", "wv", "wo", "conv_in", "conv_dw", "conv_out", "ffn_in", "ffn_out",
               *(f"{ln}.{k}" for ln in ("ln_attn", "ln_conv", "ln_ffn") for k in "gb"))


@dataclasses.dataclass(frozen=True)
class ASRModelConfig:
    n_mels: int = 80
    d_model: int = 144
    num_heads: int = 4
    num_layers: int = 3
    ffn_mult: int = 4
    conv_kernel: int = 9
    vocab_size: int = 13  # incl. blank=0; overridden by the trained vocab


def expected_keys(cfg: ASRModelConfig) -> set:
    return ({f"layers.{i}.{k}" for i in range(cfg.num_layers) for k in _LAYER_KEYS}
            | {"embed", "ln_out.g", "ln_out.b", "head.w", "head.b"})


def init_params(cfg: ASRModelConfig, generator: torch.Generator, device="cpu",
                dtype=torch.float32) -> dict:
    """Matrices N(0, 1 / fan_in), the depthwise conv N(0, 1 / k), unit
    LayerNorm gains, zero biases, at the JAX init's shapes
    (asr_model.py:59); `layers` is a list, as there."""
    ini, d = _Init(generator, device, dtype), cfg.d_model

    def w(ins, outs):
        return ini.normal(ins, outs, std=(1.0 / ins) ** 0.5)

    def ln():
        return {"g": ini.ones(d), "b": ini.zeros(d)}

    layers = [{"ln_attn": ln(), "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
               "ln_conv": ln(), "conv_in": w(d, 2 * d),
               "conv_dw": ini.normal(cfg.conv_kernel, d, std=(1.0 / cfg.conv_kernel) ** 0.5),
               "conv_out": w(d, d), "ln_ffn": ln(), "ffn_in": w(d, cfg.ffn_mult * d),
               "ffn_out": w(cfg.ffn_mult * d, d)} for _ in range(cfg.num_layers)]
    return {"embed": w(SUBSAMPLE * cfg.n_mels, d), "layers": layers, "ln_out": ln(),
            "head": {"w": w(d, cfg.vocab_size), "b": ini.zeros(cfg.vocab_size)}}


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


def _sin_positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * np.float32(-np.log(10000.0) / d))
    pe = torch.zeros(t, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def logits(params: dict, cfg: ASRModelConfig, wav_16k: torch.Tensor,
           wav_len: Optional[torch.Tensor] = None):
    """wav (B, T) float32 at 16 kHz -> (CTC logits (B, T // (HOP x SUBSAMPLE),
    vocab), frame paddings (B, F) in {0, 1}, 1 = padded), the paddings from
    the rows' sample lengths `wav_len` (B,) (none padded without it)."""
    mel = mel_spectrogram(wav_16k, 400, cfg.n_mels, SR, HOP, 400)  # (B, M, F)
    n_mel = mel.shape[2]
    if wav_len is None:
        mframes = None
        mvalid = mel.new_ones(mel.shape[0], 1, n_mel)
    else:
        # only the mel frames wholly inside the valid samples count: frame f
        # covers samples [f x HOP - pad_left, f x HOP - pad_left + WIN), with
        # pad_left = (WIN - HOP) // 2 = 120 of reflect padding
        win, pad_left = 400, (400 - HOP) // 2
        mframes = torch.clamp((wav_len.to(torch.int64) - (win - pad_left)) // HOP + 1, min=1)
        mvalid = (torch.arange(n_mel, device=mel.device)[None, None, :]
                  < mframes[:, None, None]).to(mel.dtype)
    denom = torch.clamp(mvalid.sum(dim=-1, keepdim=True), min=1.0)
    mu = (mel * mvalid).sum(dim=-1, keepdim=True) / denom
    var = ((mel - mu) ** 2 * mvalid).sum(dim=-1, keepdim=True) / denom
    x = (((mel - mu) * torch.rsqrt(var + 1e-5)) * mvalid).transpose(1, 2)  # (B, F, M)
    f = (x.shape[1] // SUBSAMPLE) * SUBSAMPLE
    x = x[:, :f].reshape(x.shape[0], f // SUBSAMPLE, SUBSAMPLE * cfg.n_mels)
    x = x @ params["embed"] + _sin_positions(x.shape[1], cfg.d_model, x.device)

    b, t, d = x.shape
    h = cfg.num_heads
    if mframes is None:
        pad = x.new_zeros(b, t)
    else:
        frames = torch.clamp(mframes // SUBSAMPLE, min=1)
        pad = (torch.arange(t, device=x.device)[None, :] >= frames[:, None]).to(x.dtype)
    attn_bias = pad[:, None, None, :] * -1e9  # (B, 1, 1, T)
    k_half = cfg.conv_kernel // 2

    for lp in params["layers"]:
        y = _layer_norm(lp["ln_attn"], x)
        q, k, v = ((y @ lp[w]).reshape(b, t, h, d // h).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // h) + attn_bias, dim=-1)
        x = x + (a @ v).transpose(1, 2).reshape(b, t, d) @ lp["wo"]

        y = _layer_norm(lp["ln_conv"], x)
        gates = y @ lp["conv_in"]
        y = gates[..., :d] * torch.sigmoid(gates[..., d:])
        y = y * (1.0 - pad[..., None])  # padded frames don't leak via the conv
        y = F.conv1d(y.transpose(1, 2), lp["conv_dw"].T[:, None, :], padding=k_half,
                     groups=d).transpose(1, 2)
        x = x + F.silu(y) @ lp["conv_out"]

        y = _layer_norm(lp["ln_ffn"], x)
        x = x + F.silu(y @ lp["ffn_in"]) @ lp["ffn_out"]

    x = _layer_norm(params["ln_out"], x)
    return x @ params["head"]["w"] + params["head"]["b"], pad


def ctc_loss(params: dict, cfg: ASRModelConfig, wavs, wav_len, labels, label_len):
    """(mean over rows of the row's CTC loss (blank 0) / max(label_len, 1),
    the fraction of unpadded frames whose argmax is not the blank). labels
    (B, L) 1-based, valid up to label_len; see the module docstring for a
    row no path can emit."""
    lgts, pad = logits(params, cfg, wavs, wav_len)
    logp = torch.log_softmax(lgts.float(), dim=-1)
    valid = 1.0 - pad
    per_seq = F.ctc_loss(logp.transpose(0, 1), labels.long(), valid.sum(dim=1).long(),
                         label_len.long(), blank=0, reduction="none", zero_infinity=True)
    loss = torch.mean(per_seq / torch.clamp(label_len.float(), min=1.0))
    nonblank = (lgts.argmax(dim=-1) != 0).to(valid.dtype)
    frac_emitting = torch.sum(nonblank * valid) / torch.clamp(valid.sum(), min=1.0)
    return loss, frac_emitting


def greedy_decode(frame_ids: np.ndarray, n_frames: int) -> List[int]:
    """CTC best-path collapse of per-frame argmax ids: drop repeats then
    blanks (id 0)."""
    ids = np.asarray(frame_ids[:n_frames])
    keep = np.ones(len(ids), bool)
    keep[1:] = ids[1:] != ids[:-1]
    out = ids[keep]
    return [int(i) for i in out if i != 0]


def token_error_rate(ref: Sequence, hyp: Sequence) -> float:
    """Levenshtein distance / len(ref), the ASR quality metric."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return float(n > 0)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
        prev = cur
    return prev[n] / m


# ---------------------------------------------------------------------------
# checkpoint: one npz of the flattened params, the vocab and the config


def save_ckpt(path: str, params, cfg: ASRModelConfig, vocab: Sequence[str]):
    """`params` as numpy arrays or tensors, in the JAX package's layout."""
    if len(vocab) + 1 != cfg.vocab_size:
        raise ValueError(f"a vocab of {len(vocab)} needs vocab_size {len(vocab) + 1}, "
                         f"not {cfg.vocab_size}")
    flat = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in flatten_params(params).items()}
    np.savez(path, __vocab__=np.asarray(list(vocab)),
             __cfg__=np.asarray(json.dumps(dataclasses.asdict(cfg))), **flat)


def load_ckpt(path: str, device="cpu"):
    """-> (params as f32 tensors on `device`, cfg, vocab list). The file may
    store any float dtype (the shipped checkpoint is fp16)."""
    with np.load(path) as raw:
        cfg = ASRModelConfig(**json.loads(str(raw["__cfg__"])))
        vocab = [str(v) for v in raw["__vocab__"]]
        flat = {k: raw[k] for k in raw.files if not k.startswith("__")}
    missing = expected_keys(cfg) - set(flat)
    if missing:
        raise KeyError(f"{path} lacks {sorted(missing)}")
    return from_numpy_tree(unflatten_params(flat), device, torch.float32), cfg, vocab


class NativeASR:
    """The trained `fn(wav, sr) -> str` for transcribe.py's --asr_module hook
    (the reference worker's model slot, transcribe_to_dataset.py:219-247).
    Raises FileNotFoundError when no weights exist. Each clip is zero-padded
    to a power-of-two length, as the JAX recognizer pads it, so both run the
    model on the same input."""

    def __init__(self, path: Optional[str] = None, sep: str = "", device="cuda"):
        path = path or os.environ.get("HYDRAVOX_ASR_NPZ") or _ASSET
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.device = resolve_device(device)
        self.params, self.cfg, self.vocab = load_ckpt(path, self.device)
        self.sep = sep

    @torch.inference_mode()
    def __call__(self, wav: np.ndarray, sr: int = SR) -> str:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(wav, np.float32).reshape(-1)))
        x = resample_linear(x.to(self.device)[None], sr, SR)[0]
        n = max(x.shape[0], HOP * SUBSAMPLE * 2)
        padded = x.new_zeros(1 << int(np.ceil(np.log2(n))))
        padded[:x.shape[0]] = x
        lgts, pad = logits(self.params, self.cfg, padded[None],
                           torch.tensor([x.shape[0]], device=self.device))
        n_frames = int((1 - pad[0]).sum())
        ids = greedy_decode(lgts[0].argmax(dim=-1).cpu().numpy(), n_frames)
        return self.sep.join(self.vocab[i - 1] for i in ids)


@functools.lru_cache(maxsize=1)
def _shared_asr() -> NativeASR:
    return NativeASR()


def native_asr(wav: np.ndarray, sr: int = SR) -> str:
    """Module-level hook (`--asr_module
    flowmirror_hydravox_tpu_torch.preprocess.asr_model.native_asr`): one
    shared NativeASR on the card, built on first use."""
    return _shared_asr()(wav, sr)
