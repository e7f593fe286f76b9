"""Weight-only int8 for the LLM's decode weights: a copy of
flowmirror_hydravox_tpu/ops/quant.py on torch tensors.

Scheme: symmetric per-output-channel. For a weight w of shape (..., H, O)
used as `x @ w`:
    scale[..., o] = max_h |w[..., h, o]| / 127        (float32)
    w8 = round(w / scale)  in int8 (round half to even, clipped to +-127)
    x @ w  ~=  (x @ w8.to(x.dtype)) * scale
The per-weight error is at most half a quantization step (0.5 / 127 of the
channel's largest magnitude). The scale leaf sits beside its weight as
`<name>@q8scale`, shaped (..., 1, O), as in the JAX tree.

What is quantized (`quantize_llm_params`): the backbone's seven layer
matrices, the MTP heads' v/o projections and MLP (their q/k projections are
never multiplied and stay dense) and the shared `llm_decoder`. Embeddings,
norms and biases keep their dtype; the flow and HiFT are never quantized.

These are plain tensor code, as the JAX package computes them outside any
Pallas kernel. The decode MLP of an int8 tree goes through the int8 form of
the fused MLP kernel (`ops/mlp_gemv.py`, with the scales); every other
product against an int8 leaf goes through `matmul_q`.
"""

from __future__ import annotations

from typing import Iterable

import torch

QWEN2_LAYER_MATS = (
    "q_proj_w",
    "k_proj_w",
    "v_proj_w",
    "o_proj_w",
    "gate_proj_w",
    "up_proj_w",
    "down_proj_w",
)
MTP_HEAD_MATS = ("v_proj_w", "o_proj_w", "gate_proj_w", "up_proj_w", "down_proj_w")
MLP_MATS = ("gate_proj_w", "up_proj_w", "down_proj_w")
SCALE_SUFFIX = "@q8scale"
QUANTIZE_MODES = (None, "", "none", "bf16", "int8")  # what Engine(quantize=) takes


def check_mode(mode):
    """Raise ValueError for a `quantize` value that is not a mode."""
    if mode not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {mode!r}")


def quantize_weight_int8(w: torch.Tensor):
    """Quantize `w` (..., H, O) symmetric per-output-channel over axis -2.

    Returns (w8 int8 of w's shape, scale float32 (..., 1, O))."""
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return w8, scale


def matmul_q(x: torch.Tensor, layer: dict, name: str) -> torch.Tensor:
    """`x @ layer[name]`, dequantizing on the product's output when the leaf
    is int8: `(x @ w8.to(x.dtype)) * scale`, cast to x's dtype (the JAX
    order, so a bf16 product is rounded before the scale). Two float dtypes
    promote as `jnp.matmul` promotes them (bf16 @ f32 is an f32 product)."""
    w = layer[name]
    if w.dtype == torch.int8:
        y = x @ w.to(x.dtype)
        return (y * layer[name + SCALE_SUFFIX].reshape(-1)).to(x.dtype)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def mlp_scales(layer: dict):
    """The (gate, up, down) scales of an int8 MLP, None for a dense one."""
    if layer["gate_proj_w"].dtype != torch.int8:
        return None
    return tuple(layer[n + SCALE_SUFFIX] for n in MLP_MATS)


def quantize_layer_dict(layers: dict, names: Iterable[str] = QWEN2_LAYER_MATS) -> dict:
    """Quantize the named matrices of a (possibly layer-stacked) param dict.

    Adds `<name>@q8scale` leaves next to the int8 weights and leaves the
    rest as it is. Leaves that are int8 already are skipped."""
    out = dict(layers)
    for name in names:
        w = out.get(name)
        if w is None or w.dtype == torch.int8:
            continue
        out[name], out[name + SCALE_SUFFIX] = quantize_weight_int8(w)
    return out


def quantize_llm_params(params: dict) -> dict:
    """The int8 form of an LLM tree (models/llm.py layout): backbone layers,
    the MTP heads' live matrices and `llm_decoder`. The input tree is not
    modified; the leaves that stay dense are shared with it."""
    out = dict(params)
    backbone = dict(out["backbone"])
    backbone["layers"] = quantize_layer_dict(backbone["layers"])
    out["backbone"] = backbone
    out["mtp_block"] = quantize_layer_dict(out["mtp_block"], MTP_HEAD_MATS)
    if out.get("llm_decoder") is not None and out["llm_decoder"].dtype != torch.int8:
        out["llm_decoder"], out["llm_decoder" + SCALE_SUFFIX] = \
            quantize_weight_int8(out["llm_decoder"])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_bytes(tree) -> tuple:
    """(all bytes, int8 bytes) of a tree's tensors."""
    total = int8 = 0
    for leaf in _leaves(tree):
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        if leaf.dtype == torch.int8:
            int8 += nbytes
    return total, int8


def quantized_fraction(params: dict) -> float:
    """Fraction of the tree's bytes stored as int8 (diagnostic)."""
    total, int8 = tree_bytes(params)
    return int8 / max(total, 1)


def dequantize_layer_dict(layers: dict) -> dict:
    """Inverse of quantize_layer_dict (bf16 weights; lossy)."""
    out = {}
    for name, w in layers.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        if isinstance(w, torch.Tensor) and w.dtype == torch.int8:
            out[name] = (w.to(torch.float32) * layers[name + SCALE_SUFFIX]).to(torch.bfloat16)
        else:
            out[name] = w
    return out
