"""Decode attention against a preallocated KV cache: the Hopper kernel and its
plain PyTorch version.

`decode_attention_cuda` launches `csrc/decode_attention.cu`, the hand-written
replacement for the TPU kernel
`flowmirror_hydravox_tpu/ops/pallas_attention.py::pallas_decode_attention`.
It takes `decode_attention`'s batched contract
(`flowmirror_hydravox_tpu/ops/attention.py:103-124`): q (B, T, Hq, D), k/v
(B, S_max, Hkv, D), per-row `cache_len` (B,). Query t of row b attends to key
positions <= cache_len[b] + t. It is bound by bytes on the card (q, the valid
K/V rows and the output over 3.35 TB/s); see the note in the source.

The kernel is built with `nvcc -gencode arch=compute_90a,code=sm_90a` into a
shared library with a plain C interface at first use, under `build/` in this
package, and loaded with ctypes. There is no fallback: a CUDA tensor launches
the kernel or raises. `decode_attention_ref` is the plain version; the CPU
path and the on-card check use it.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import nvcc_build

NEG_INF = -1.0e10

KERNEL_SOURCE = nvcc_build.CSRC_DIR / "decode_attention.cu"
LIBRARY = nvcc_build.BUILD_DIR / "libhv_decode_attention.so"
SUPPORTED_HEAD_DIMS = (16, 64)  # tiny_config(), HydraVoxConfig()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Enough blocks to fill the H100's 132 SMs twice; decode steps with few row
# tiles split S to get there.
_TARGET_BLOCKS = 264
_MIN_SPLIT_KEYS = 128

launch_count = 0  # kernel launches through decode_attention_cuda
_lib = None
_lib_lock = threading.Lock()


def masked_gqa(q, k, v, bias, scale=None):
    """Grouped-query attention with an additive f32 bias (B, T, S).
    q (B, T, Hq, D), k/v (B, S, Hkv, D) -> (B, T, Hq, D)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    qg = q.reshape(b, t, hkv, group, d)
    # (B, Hkv, G, T, S)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k).to(torch.float32) * scale
    if bias is not None:
        logits = logits + bias[:, None, None]
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.reshape(b, t, hq, d)


def decode_attention_ref(q, k_cache, v_cache, cache_len):
    """Plain version: block-causal mask key_pos <= cache_len + i as an additive
    -1e10 bias (the JAX `mha` semantics). Returns (B, T, Hq, D) in q's dtype."""
    t = q.shape[1]
    s_max = k_cache.shape[1]
    key_pos = torch.arange(s_max, device=q.device)[None, None, :]
    q_pos = cache_len.to(q.device).long()[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    bias = torch.where(key_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
    return masked_gqa(q, k_cache, v_cache, bias)


def build_library(force: bool = False):
    """Compile the kernel source into LIBRARY unless an up-to-date build exists."""
    return nvcc_build.build_library(KERNEL_SOURCE, LIBRARY, force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.hv_decode_attention.restype = ctypes.c_int
            lib.hv_decode_attention.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_void_p]
            )
            lib.hv_decode_attention_rows_per_block.restype = ctypes.c_int
            lib.hv_decode_attention_keys_per_tile.restype = ctypes.c_int
            _lib = lib
        return _lib


def plan_splits(batch: int, n_tok: int, hq: int, hkv: int, s_max: int,
                rows_per_block: int, keys_per_tile: int):
    """(splits, chunk): S is cut into `splits` chunks of `chunk` keys (a
    multiple of the key tile) when the row tiles alone leave SMs idle."""
    row_tiles = -(-(hq // hkv) * n_tok // rows_per_block)
    base = batch * hkv * row_tiles
    splits = 1
    if base < _TARGET_BLOCKS:
        splits = min(-(-_TARGET_BLOCKS // base), max(1, s_max // _MIN_SPLIT_KEYS))
    chunk = -(-s_max // splits)
    chunk = -(-chunk // keys_per_tile) * keys_per_tile
    return -(-s_max // chunk), chunk


def decode_attention_cuda(q, k_cache, v_cache, cache_len):
    """Launch the Hopper kernel. q (B, T, Hq, D), k/v (B, S_max, Hkv, D),
    cache_len (B,) int32, all contiguous on one CUDA device; q/k/v float32 or
    bfloat16 of one dtype. Returns (B, T, Hq, D) in q's dtype."""
    global launch_count
    if not q.is_cuda:
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    dev = q.device
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache), ("cache_len", cache_len)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"cache_len must be int32, got {cache_len.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)}")
    b, t, hq, d = q.shape
    bk, s_max, hkv, dk = k_cache.shape
    if bk != b or dk != d or hq % hkv != 0 or tuple(cache_len.shape) != (b,):
        raise ValueError(f"inconsistent shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"cache_len {tuple(cache_len.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (kernel built for {SUPPORTED_HEAD_DIMS})")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("cache_len", cache_len)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")

    lib = _library()
    splits, chunk = plan_splits(b, t, hq, hkv, s_max,
                                lib.hv_decode_attention_rows_per_block(),
                                lib.hv_decode_attention_keys_per_tile())
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((splits, b, t, hq, d), dtype=torch.float32, device=dev)
        part_ml = torch.empty((splits, b, t, hq, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hv_decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        b, t, hq, hkv, d, s_max, splits, chunk,
        float(d ** -0.5 * math.log2(math.e)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode-attention kernel launch failed (code {rc})")
    launch_count += 1
    return out
