"""Speech tokenizer (FSQ encoder over the whisper 128-mel) and speaker encoder:
a port of flowmirror_hydravox_tpu/frontend/speech_tokenizer.py (all but its
ONNX adapters).

These are the JAX package's stand-ins for the reference's ONNX extractors
(`speech_tokenizer_v3.onnx`, `campplus.onnx`, cli/frontend.py:92-116):

  - `tokenize_waveform`: 16 kHz wav -> whisper log-mel -> two stride-2 convs
    -> pre-norm transformer encoder (rotary, dense softmax attention) -> FSQ
    over 8 dims of 3 levels (6561 codes) at 25 tokens/s;
  - `speaker_embedding`: 80-bin log-mel -> four dilated convs -> mean/std
    pooling -> a 192-d projection.

Parameter trees keep the JAX layouts: convs (O, I, K), which is torch's
`conv1d` layout, matmuls (in, out), and the encoder layers' leaves stacked
on a leading layer axis. No Pallas kernel lies here: the attention is plain
dense attention in both packages. `jax.nn.gelu` is the tanh approximation,
and so is every GELU here.

The training half (train/train_frontend.py): the initial trees, the FSQ
straight-through quantiser, the mel decoder and its reconstruction loss, and
the AAM-softmax speaker loss. Initial trees are drawn from a
`torch.Generator` at the JAX init's shapes and scales (the JAX draws come
from `jax.random`, which torch cannot reproduce): trees cross between the
packages as npz files.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rope import apply_rope_halved, rope_cos_sin
from ..params import _Init
from ..utils.audio import whisper_log_mel


@dataclasses.dataclass(frozen=True)
class SpeechTokenizerConfig:
    n_mels: int = 128
    dim: int = 512
    num_layers: int = 6
    num_heads: int = 8
    fsq_levels: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 3, 3)  # 3^8 = 6561
    token_rate: int = 25  # tokens/sec (mel is 100 Hz -> stride 4 total)


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    n_mels: int = 80
    dim: int = 256
    num_layers: int = 4
    embed_dim: int = 192


_TOKENIZER_LAYER_KEYS = ("ln1", "qkv", "qkv_b", "out", "ln2", "ff1", "ff1_b", "ff2", "ff2_b")


def expected_keys(cfg) -> set:
    """The flat keys of the parameter tree that `cfg`'s extractor reads."""
    if isinstance(cfg, SpeechTokenizerConfig):
        return ({"conv1.w", "conv1.b", "conv2.w", "conv2.b", "ln_f", "fsq_proj"}
                | {f"layers.{k}" for k in _TOKENIZER_LAYER_KEYS})
    return {f"convs.{i}.{k}" for i in range(cfg.num_layers) for k in "wb"} | {"proj"}


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _rms(x, w, eps=1e-6):
    var = torch.mean(x.float() ** 2, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def _encoder_block(layer: dict, x, heads: int):
    b, t, d = x.shape
    hd = d // heads
    qkv = _rms(x, layer["ln1"]) @ layer["qkv"] + layer["qkv_b"]
    q, k, v = torch.split(qkv, d, dim=-1)
    cos, sin = rope_cos_sin(torch.arange(t, device=x.device), hd, 10000.0)
    q = apply_rope_halved(q.reshape(b, t, heads, hd), cos, sin)
    k = apply_rope_halved(k.reshape(b, t, heads, hd), cos, sin)
    v = v.reshape(b, t, heads, hd)
    logits = torch.einsum("bthd,bshd->bhts", q, k) * (hd ** -0.5)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, d)
    x = x + attn @ layer["out"]
    h = _rms(x, layer["ln2"])
    return x + _gelu(h @ layer["ff1"] + layer["ff1_b"]) @ layer["ff2"] + layer["ff2_b"]


def _stacked_layers(ini: _Init, d: int, n: int) -> dict:
    """`n` encoder layers (JAX `_layer_init`), each leaf stacked on a leading
    layer axis."""
    s = (n,)
    return {"ln1": ini.ones(*s, d), "qkv": ini.normal(*s, d, 3 * d, std=0.02),
            "qkv_b": ini.zeros(*s, 3 * d), "out": ini.normal(*s, d, d, std=0.02),
            "ln2": ini.ones(*s, d), "ff1": ini.normal(*s, d, 4 * d, std=0.02),
            "ff1_b": ini.zeros(*s, 4 * d), "ff2": ini.normal(*s, 4 * d, d, std=0.02),
            "ff2_b": ini.zeros(*s, d)}


def init_tokenizer_params(cfg: SpeechTokenizerConfig, generator: torch.Generator,
                          device="cpu", dtype=torch.float32) -> dict:
    """The FSQ encoder's tree (JAX speech_tokenizer.py:77): N(0, 0.02)
    matrices and convs, zero biases, unit norms."""
    ini, d = _Init(generator, device, dtype), cfg.dim
    return {"conv1": {"w": ini.normal(d, cfg.n_mels, 3, std=0.02), "b": ini.zeros(d)},
            "conv2": {"w": ini.normal(d, d, 3, std=0.02), "b": ini.zeros(d)},
            "layers": _stacked_layers(ini, d, cfg.num_layers),
            "ln_f": ini.ones(d),
            "fsq_proj": ini.normal(d, len(cfg.fsq_levels), std=0.02)}


def init_decoder_params(cfg: SpeechTokenizerConfig, generator: torch.Generator,
                        device="cpu", dtype=torch.float32) -> dict:
    """The mel decoder of self-supervised tokenizer training (JAX :153): FSQ
    lattice values (25 Hz) -> transformer -> 4x nearest upsample + convs ->
    128-mel (100 Hz). Only the trainer uses it."""
    ini, d = _Init(generator, device, dtype), cfg.dim
    return {"in_proj": ini.normal(len(cfg.fsq_levels), d, std=0.02),
            "layers": _stacked_layers(ini, d, cfg.num_layers),
            "ln_f": ini.ones(d),
            "conv1": {"w": ini.normal(d, d, 3, std=0.02), "b": ini.zeros(d)},
            "conv2": {"w": ini.normal(d, d, 3, std=0.02), "b": ini.zeros(d)},
            "out_proj": ini.normal(d, cfg.n_mels, std=0.02)}


def init_speaker_params(cfg: SpeakerEncoderConfig, generator: torch.Generator,
                        device="cpu", dtype=torch.float32) -> dict:
    """The speaker encoder's tree (JAX :266): N(0, 0.05) convs and
    projection, zero biases."""
    ini, ch, convs = _Init(generator, device, dtype), cfg.n_mels, []
    for _ in range(cfg.num_layers):
        convs.append({"w": ini.normal(cfg.dim, ch, 3, std=0.05), "b": ini.zeros(cfg.dim)})
        ch = cfg.dim
    return {"convs": convs, "proj": ini.normal(2 * cfg.dim, cfg.embed_dim, std=0.05)}


def _encoder_stack(layers: dict, h, heads: int):
    for i in range(layers["ln1"].shape[0]):
        h = _encoder_block({k: v[i] for k, v in layers.items()}, h, heads)
    return h


def encode_fsq_values(params: dict, cfg: SpeechTokenizerConfig, mel):
    """The encoder trunk up to the FSQ projection.
    mel (B, 128, T) -> z (B, T//4, n_fsq_dims), before quantisation."""
    h = _gelu(F.conv1d(mel, params["conv1"]["w"], params["conv1"]["b"], stride=2, padding=1))
    h = _gelu(F.conv1d(h, params["conv2"]["w"], params["conv2"]["b"], stride=2, padding=1))
    h = _encoder_stack(params["layers"], h.transpose(1, 2), cfg.num_heads)
    return _rms(h, params["ln_f"]) @ params["fsq_proj"]


def fsq_values(z, levels: Tuple[int, ...]):
    """The per-dim lattice value tanh(z) * (L - 1) / 2 before rounding."""
    half = (torch.tensor(levels, dtype=torch.float32, device=z.device) - 1.0) / 2.0
    return torch.tanh(z.float()) * half


def fsq_encode(z, levels: Tuple[int, ...]):
    """Finite scalar quantisation: bounded tanh lattice -> code index. Both
    jnp.round and torch.round round half to even."""
    half = (torch.tensor(levels, dtype=torch.float32, device=z.device) - 1.0) / 2.0
    q = torch.round(fsq_values(z, levels)) + half  # per dim in [0, L - 1]
    mult = torch.tensor(np.cumprod([1] + list(levels[:-1])), dtype=torch.float32,
                        device=z.device)
    return torch.sum(q * mult, dim=-1).to(torch.int32)


def fsq_quantize_ste(z, levels: Tuple[int, ...]):
    """FSQ with a straight-through estimator (the training path): the
    lattice values in [-1, 1] per dim; the gradient flows through the
    bounded tanh as if rounding were the identity."""
    half = (torch.tensor(levels, dtype=torch.float32, device=z.device) - 1.0) / 2.0
    bounded = torch.tanh(z.float())
    quant = torch.round(bounded * half) / half
    return (bounded + (quant - bounded).detach()).to(z.dtype)


def reconstruct_mel(enc_params: dict, dec_params: dict, cfg: SpeechTokenizerConfig, mel):
    """Autoencode mel through the FSQ bottleneck. mel (B, 128, T) ->
    (B, 128, T'), T' = (T // 4) x 4 (the subsampled grid)."""
    q = fsq_quantize_ste(encode_fsq_values(enc_params, cfg, mel), cfg.fsq_levels)
    h = _encoder_stack(dec_params["layers"], q @ dec_params["in_proj"], cfg.num_heads)
    h = _rms(h, dec_params["ln_f"]).transpose(1, 2)  # (B, D, T/4)
    for conv in (dec_params["conv1"], dec_params["conv2"]):
        h = _gelu(F.conv1d(h.repeat_interleave(2, dim=-1), conv["w"], conv["b"], padding=1))
    return (h.transpose(1, 2) @ dec_params["out_proj"]).transpose(1, 2)


def tokenizer_recon_loss(enc_params: dict, dec_params: dict, cfg: SpeechTokenizerConfig,
                         mel, mel_len=None):
    """Masked MSE of the reconstruction (self-supervised tokenizer
    training); every frame of the subsampled grid without `mel_len`."""
    t4 = (mel.shape[2] // 4) * 4
    target = mel[:, :, :t4]
    pred = reconstruct_mel(enc_params, dec_params, cfg, mel)[:, :, :t4]
    err = (pred.float() - target.float()) ** 2
    if mel_len is None:
        return err.mean()
    mask = (torch.arange(t4, device=mel.device)[None, :] < mel_len[:, None]).float()
    return torch.sum(err * mask[:, None, :]) / torch.clamp(mask.sum() * mel.shape[1], min=1.0)


def aam_softmax_loss(embeddings, classifier, labels, margin: float = 0.2,
                     scale: float = 30.0):
    """Additive-angular-margin softmax, the CAM++ / speaker-verification
    objective. embeddings (B, 192), classifier (n_spk, 192), labels (B,).
    Returns (loss, accuracy)."""
    e = embeddings / (torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True) + 1e-8)
    w = classifier / (torch.linalg.vector_norm(classifier, dim=-1, keepdim=True) + 1e-8)
    cos = e @ w.T  # (B, n_spk)
    theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    onehot = F.one_hot(labels.long(), classifier.shape[0]).to(cos.dtype)
    logits = scale * torch.where(onehot > 0, torch.cos(theta + margin), cos)
    loss = -torch.mean(torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1))
    acc = torch.mean((cos.argmax(dim=-1) == labels.long()).float())
    return loss, acc


def tokenize_mel(params: dict, cfg: SpeechTokenizerConfig, mel):
    """mel: (B, 128, T) whisper log-mel (100 Hz) -> (B, T//4) tokens (25 Hz)."""
    return fsq_encode(encode_fsq_values(params, cfg, mel), cfg.fsq_levels)


def tokenize_waveform(params: dict, cfg: SpeechTokenizerConfig, wav_16k):
    """wav_16k: (B, T) -> (B, n_tokens) at 25 Hz (cli/frontend.py:92-104)."""
    return tokenize_mel(params, cfg, whisper_log_mel(wav_16k, n_mels=cfg.n_mels))


def speaker_embedding(params: dict, cfg: SpeakerEncoderConfig, mel80):
    """mel80: (B, 80, T) log-mel -> (B, 192) embedding (the campplus interface,
    cli/frontend.py:105-116: mean-subtracted features, stats pooling)."""
    x = mel80 - torch.mean(mel80, dim=-1, keepdim=True)
    for i, conv in enumerate(params["convs"]):
        dil = 2 ** min(i, 3)
        x = torch.relu(F.conv1d(x, conv["w"], conv["b"], padding=dil, dilation=dil))
    mean = torch.mean(x, dim=-1)
    std = torch.sqrt(torch.clamp_min(torch.var(x, dim=-1, unbiased=False), 1e-8))
    return torch.cat([mean, std], dim=-1) @ params["proj"]
