"""F5-TTS-style DiT velocity estimator: port of
flowmirror_hydravox_tpu/models/dit.py, with its streaming (static-chunk)
attention mask and its train-time dropout.

  - AdaLN-Zero modulated transformer blocks.
  - Causal conv position embedding (two left-padded grouped convs + Mish).
  - The reference's rotary quirk: x-transformers rotates only the first
    `dim_head` channels of the flattened (heads * dim_head) q/k, i.e. head 0
    only, in interleaved pairs. Kept for weight parity.
  - Padding rows are fully masked with an additive -1e10 bias, which gives
    them a uniform softmax; a boolean-masked SDPA would give NaN there.

  - Train-time dropout (`forward(dropout_masks=, dropout_rate=)`): inverted
    dropout on each block's attention output and FF hidden; the keep masks
    come from the caller (a noise source, see noise.py), since torch cannot
    replay the JAX key chain.

Matmuls and convs run in the param dtype, softmax and LayerNorm statistics
in f32. Conv weights are (O, I/g, K), torch's own layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import DiTConfig
from ..ops.rope import rope_cos_sin
from ..params import unstack

NEG_INF = -1.0e10


def linear(p, x):
    return x @ p["w"] + p["b"]


def conv1d(p, x, *, groups: int = 1):
    """VALID conv. x: (B, C, T); p['w']: (O, I/g, K)."""
    return F.conv1d(x, p["w"], p["b"], groups=groups)


def dropout(x, rate: float, keep):
    """Inverted dropout with the keep mask `keep` (x's shape, bool); the
    identity when `keep` is None or rate is 0. The scale 1 - rate is rounded
    to x's dtype first, as JAX rounds a Python float against a bf16 array."""
    if keep is None or rate <= 0.0:
        return x
    scale = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(keep, x / scale, torch.zeros_like(x))


def layer_norm(x, eps: float = 1e-6):
    """LayerNorm without affine params, statistics in f32."""
    dt = x.dtype
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps)).to(dt)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def timestep_embedding(params: dict, t, freq_embed_dim: int):
    """Sinusoidal embedding (scale 1000) + MLP. t: (B,) in [0, 1] -> (B, dim)."""
    half = freq_embed_dim // 2
    emb_scale = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb_scale)
    ang = 1000.0 * t.to(torch.float32)[:, None] * freqs[None, :]
    sincos = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    hidden = linear(params["time_mlp_in"], sincos.to(params["time_mlp_in"]["w"].dtype))
    return linear(params["time_mlp_out"], F.silu(hidden))


def causal_conv_pos_embed(params: dict, x):
    """(B, T, D) -> (B, T, D)."""
    h = x.transpose(1, 2)  # (B, D, T)
    h = mish(conv1d(params["conv_pos1"], F.pad(h, (30, 0)), groups=16))
    h = mish(conv1d(params["conv_pos2"], F.pad(h, (30, 0)), groups=16))
    return h.transpose(1, 2)


def _apply_rope_flat_partial(x, cos, sin, rot_dim: int):
    """Rotate only the first rot_dim channels of the flat (B, T, heads*dim_head)
    tensor, interleaved pair layout."""
    xr, xu = x[..., :rot_dim], x[..., rot_dim:]
    shape = xr.shape
    pairs = xr.reshape(shape[:-1] + (rot_dim // 2, 2))
    x1, x2 = pairs[..., 0], pairs[..., 1]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(shape).to(x.dtype)
    return torch.cat([rotated, xu], dim=-1)


def _attention(block, x, mask_bias, cos, sin, heads: int, dim_head: int):
    b, t, _ = x.shape
    q = _apply_rope_flat_partial(linear(block["to_q"], x), cos, sin, dim_head)
    k = _apply_rope_flat_partial(linear(block["to_k"], x), cos, sin, dim_head)
    v = linear(block["to_v"], x)
    q = q.reshape(b, t, heads, dim_head)
    k = k.reshape(b, t, heads, dim_head)
    v = v.reshape(b, t, heads, dim_head)
    logits = torch.einsum("bthd,bshd->bhts", q, k).to(torch.float32) * (dim_head ** -0.5)
    logits = logits + mask_bias[:, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, heads * dim_head)
    return linear(block["to_out"], out)


def _dit_block(block, x, t_emb, mask_bias, cos, sin, heads: int, dim_head: int,
               drop_rate: float = 0.0, keep=(None, None)):
    """AdaLN-Zero block (modules.py:500-530); attention-out and FF dropout
    at train time with the keep masks `keep` (attention, FF)."""
    mod = linear(block["attn_norm_linear"], F.silu(t_emb))  # (B, 6*dim)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = torch.chunk(mod, 6, dim=-1)
    norm = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    attn_out = _attention(block, norm, mask_bias, cos, sin, heads, dim_head)
    x = x + gate_msa[:, None] * dropout(attn_out, drop_rate, keep[0])
    ff_norm = layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    ff = linear(block["ff_out"], dropout(
        F.gelu(linear(block["ff_in"], ff_norm), approximate="tanh"), drop_rate, keep[1]))
    return x + gate_mlp[:, None] * ff


def forward(params: dict, cfg: DiTConfig, x, mask, mu, t, spks, cond, streaming: bool = False,
            dropout_masks=None, dropout_rate: float = 0.0):
    """Velocity estimate (B, mel_dim, T). x (B, mel_dim, T) noised input,
    mask (B, 1, T) validity, mu (B, mu_dim, T), t (B,), spks (B, spk_dim),
    cond (B, mel_dim, T). Mirrors DiT.forward (dit.py:145-176).

    `dropout_masks`: train-time dropout, one (attention (B, T, dim), FF
    (B, T, dim * ff_mult)) pair of bool keep masks per block, applied at
    `dropout_rate` (JAX `dropout_rng=`, :270-278); inference passes neither.

    `streaming` adds the static-chunk mask: frame q attends to frame k only
    when k // static_chunk_size <= q // static_chunk_size. A row left with no
    key keeps the finite NEG_INF bias on every key, as in the JAX package."""
    dtype = params["input_proj"]["w"].dtype
    x = x.transpose(1, 2).to(dtype)
    mu = mu.transpose(1, 2).to(dtype)
    cond = cond.transpose(1, 2).to(dtype)
    spks = spks.to(dtype)
    b, seq_len, _ = x.shape

    t_emb = timestep_embedding(params, t, cfg.freq_embed_dim)  # (B, dim)
    spk_bc = spks[:, None, :].expand(b, seq_len, spks.shape[-1])
    h = linear(params["input_proj"], torch.cat([x, cond, mu, spk_bc], dim=-1))
    h = causal_conv_pos_embed(params, h) + h

    cos, sin = rope_cos_sin(torch.arange(seq_len, device=x.device), cfg.dim_head, cfg.rope_theta)
    valid = mask[:, 0, :] > 0  # (B, T)
    attn = valid[:, None, :] & valid[:, :, None]
    if streaming:
        chunk = torch.arange(seq_len, device=x.device) // cfg.static_chunk_size
        attn = attn & (chunk[None, :] <= chunk[:, None])[None]
    mask_bias = torch.where(attn, 0.0, NEG_INF).to(torch.float32)

    for i, block in enumerate(unstack(params["blocks"])[:cfg.depth]):
        keep = (None, None) if dropout_masks is None else dropout_masks[i]
        h = _dit_block(block, h, t_emb, mask_bias, cos, sin, cfg.heads, cfg.dim_head,
                       dropout_rate, keep)

    mod = linear(params["norm_out_linear"], F.silu(t_emb))
    scale, shift = torch.chunk(mod, 2, dim=-1)  # scale first (modules.py:262)
    h = layer_norm(h) * (1 + scale[:, None]) + shift[:, None]
    return linear(params["proj_out"], h).transpose(1, 2)
