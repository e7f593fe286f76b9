"""Qwen2-style causal decoder backbone: port of
flowmirror_hydravox_tpu/models/qwen2.py.

Parameters keep the JAX layout: matmul weights (in, out), per-layer leaves
stacked (n_layers, ...). The KV cache is preallocated at a fixed length; each
block of K new tokens is written at `cache.length` and attention runs through
`decode_attention_dispatch` (the Hopper kernel on the card). The MLP of a
decode step's block goes through `mlp_gemv` (the fused SwiGLU GEMV kernel on
the card); the prompt prefill keeps `_mlp_block` (torch.matmul), as the JAX
package leaves that product to XLA. The caller names the route.

A tree of weight-only int8 (ops/quant.py) serves as it is: every projection
goes through `matmul_q`, and the decode MLP through the kernel's int8 form
with the leaves' scales (`decode_mlp`).

`forward` is the full causal forward of training (JAX :115-164): plain
`mha` attention and `_mlp_block`, never a kernel (neither has a backward).

Unlike the JAX package, whose arrays are immutable, the cache tensors are
updated in place: `forward_block_with_cache` writes the block into the same
storage and returns a cache that shares it, with the new length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import Qwen2Config
from ..ops.attention import decode_attention_dispatch, mha
from ..ops.mlp_gemv import mlp_gemv
from ..ops.quant import MLP_MATS, matmul_q, mlp_scales
from ..ops.rope import apply_rope_halved, rope_cos_sin
from ..params import unstack


class KVCache(NamedTuple):
    k: torch.Tensor  # (n_layers, B, S_max, Hkv, D)
    v: torch.Tensor  # (n_layers, B, S_max, Hkv, D)
    length: torch.Tensor  # (B,) int32 committed prefix length


def init_kv_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def _rms_norm(x, weight, eps: float):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def embed_tokens(params: dict, token_ids):
    vocab = params["embed_tokens"].shape[0]
    return params["embed_tokens"][torch.clamp(token_ids, 0, vocab - 1).long()]


def _mlp_block(layer: dict, x):
    gate = F.silu(matmul_q(x, layer, "gate_proj_w"))
    return matmul_q(gate * matmul_q(x, layer, "up_proj_w"), layer, "down_proj_w")


def decode_mlp(layer: dict, x):
    """A decode step's MLP through `mlp_gemv`, with the scales of int8 leaves."""
    weights = [layer[n] for n in MLP_MATS]
    scales = mlp_scales(layer)
    if scales is None:
        return mlp_gemv(x, *weights)
    return mlp_gemv(x, *weights, scales=scales)


def _attention_block(layer: dict, x, cfg: Qwen2Config, cos, sin, mask):
    """Full-sequence attention (no cache). x: (B, T, H)."""
    b, t, _ = x.shape
    q = (matmul_q(x, layer, "q_proj_w") + layer["q_proj_b"]).reshape(
        b, t, cfg.num_heads, cfg.head_dim)
    k = (matmul_q(x, layer, "k_proj_w") + layer["k_proj_b"]).reshape(
        b, t, cfg.num_kv_heads, cfg.head_dim)
    v = (matmul_q(x, layer, "v_proj_w") + layer["v_proj_b"]).reshape(
        b, t, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope_halved(q, cos, sin)
    k = apply_rope_halved(k, cos, sin)
    return matmul_q(mha(q, k, v, mask).reshape(b, t, -1), layer, "o_proj_w")


def forward(params: dict, cfg: Qwen2Config, inputs_embeds, lengths=None):
    """Full causal forward (training, no cache). inputs_embeds (B, T, H);
    `lengths` (B,) valid lengths of right-padded rows: keys past a row's
    length are masked. Returns the hidden states after the final norm."""
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    pos = torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(pos[None, :].expand(b, t), cfg.head_dim, cfg.rope_theta)
    mask = (pos[:, None] >= pos[None, :])[None].expand(b, t, t)
    if lengths is not None:
        mask = mask & (pos[None, :] < lengths.to(dev)[:, None])[:, None, :]
    x = inputs_embeds
    for layer in layer_slices(params, cfg.num_layers):
        attn_in = _rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        x = x + _attention_block(layer, attn_in, cfg, cos, sin, mask)
        mlp_in = _rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, mlp_in)
    return _rms_norm(x, params["norm"], cfg.rms_norm_eps)


def layer_slices(params: dict, n_layers: int):
    """Per-layer views {name: leaf[i]} of the stacked layer leaves (the
    `@q8scale` leaves of an int8 tree among them)."""
    return unstack(params["layers"])[:n_layers]


def forward_block_with_cache(params: dict, cfg: Qwen2Config, inputs_embeds, cache: KVCache,
                             advance: Optional[torch.Tensor] = None, *,
                             decode_step: bool = False):
    """Process a block of K new tokens (B, K, H) against the KV cache.

    The block is written at positions [cache.length, cache.length + K);
    `advance` (B,) of them are committed (default K). Uncommitted slots are
    shadowed by the next block's write before they can be attended. The
    caller keeps cache.length + K <= S_max (indexing past the end raises).

    `decode_step` names the call site: True for the sampled tokens of a
    decode step, whose MLP goes through `mlp_gemv` (`decode_mlp`); False for
    a prompt prefill, whose MLP stays `_mlp_block`.

    Returns (hidden (B, K, H) after the final norm, cache with the new length).
    """
    b, kblk, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    positions = cache.length[:, None].long() + torch.arange(kblk, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    rows = torch.arange(b, device=dev)[:, None]

    x = inputs_embeds
    for i, layer in enumerate(layer_slices(params, cfg.num_layers)):
        attn_in = _rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        q = (matmul_q(attn_in, layer, "q_proj_w") + layer["q_proj_b"]).reshape(
            b, kblk, cfg.num_heads, cfg.head_dim)
        k = (matmul_q(attn_in, layer, "k_proj_w") + layer["k_proj_b"]).reshape(
            b, kblk, cfg.num_kv_heads, cfg.head_dim)
        v = (matmul_q(attn_in, layer, "v_proj_w") + layer["v_proj_b"]).reshape(
            b, kblk, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope_halved(q, cos, sin)
        k = apply_rope_halved(k, cos, sin)
        k_cache_l, v_cache_l = cache.k[i], cache.v[i]
        k_cache_l[rows, positions] = k.to(k_cache_l.dtype)
        v_cache_l[rows, positions] = v.to(v_cache_l.dtype)
        attn = decode_attention_dispatch(q.contiguous(), k_cache_l, v_cache_l, cache.length)
        x = x + matmul_q(attn.reshape(b, kblk, -1), layer, "o_proj_w")
        mlp_in = _rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        if decode_step:
            x = x + decode_mlp(layer, mlp_in)
        else:
            x = x + _mlp_block(layer, mlp_in)

    if advance is None:
        advance = torch.full((b,), kblk, dtype=torch.int32, device=dev)
    new_cache = KVCache(k=cache.k, v=cache.v, length=(cache.length + advance).to(torch.int32))
    return _rms_norm(x, params["norm"], cfg.rms_norm_eps), new_cache
