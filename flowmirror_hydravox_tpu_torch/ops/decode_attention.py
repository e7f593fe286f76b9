"""Decode attention against a preallocated KV cache: the Hopper kernel and its
plain PyTorch version.

`decode_attention_cuda` launches `csrc/decode_attention.cu`, the hand-written
replacement for the TPU kernel
`flowmirror_hydravox_tpu/ops/pallas_attention.py::pallas_decode_attention`.
It takes `decode_attention`'s batched contract
(`flowmirror_hydravox_tpu/ops/attention.py:103-124`): q (B, T, Hq, D), k/v
(B, S_max, Hkv, D), per-row `cache_len` (B,). Query t of row b attends to key
positions <= cache_len[b] + t. Its byte bound (q, the valid K/V rows and the
output over 3.35 TB/s) is far below one launch, so on the card it is bound
by latency; see the note in the source. One launch per call: the splits of S
are merged by the last block of each group, elected by an integer ticket in
a per-device buffer that the kernel leaves zeroed, so calls on one device
must share one stream (the port's do).

The kernel is built with `nvcc -gencode arch=compute_90a,code=sm_90a` into a
shared library with a plain C interface at first use, under `build/` in this
package, and loaded with ctypes. There is no fallback: a CUDA tensor launches
the kernel or raises. `decode_attention_ref` is the plain version; the CPU
path and the on-card check use it.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import nvcc_build

NEG_INF = -1.0e10

KERNEL_SOURCE = nvcc_build.CSRC_DIR / "decode_attention.cu"
LIBRARY = nvcc_build.BUILD_DIR / "libhv_decode_attention.so"
SUPPORTED_HEAD_DIMS = (16, 64)  # tiny_config(), HydraVoxConfig()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Decode steps split S until B * Hkv * row tiles * splits fills the H100's
# 132 SMs once.
_TARGET_BLOCKS = 132

launch_count = 0  # kernel launches through decode_attention_cuda
_lib = None
_lib_lock = threading.Lock()
_SCALE_LOG2 = {d: float(d ** -0.5 * math.log2(math.e)) for d in SUPPORTED_HEAD_DIMS}


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
    """The loaded library and its tile sizes (rows per tile, keys per tile),
    read once."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.hv_decode_attention.restype = ctypes.c_int
            lib.hv_decode_attention.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_void_p]
            )
            tiles = []
            for name in ("hv_decode_attention_rows_per_tile", "hv_decode_attention_keys_per_round"):
                getattr(lib, name).restype = ctypes.c_int
                tiles.append(getattr(lib, name)())
            _lib = lib, tuple(tiles)
        return _lib


@functools.lru_cache(maxsize=256)
def plan_splits(batch: int, n_tok: int, hq: int, hkv: int, s_max: int,
                rows_per_tile: int, keys_per_round: int):
    """(row_tiles, splits, chunk): the G * T rows of a KV head go in tiles of
    `rows_per_tile`, and S_max is cut into `splits` chunks of `chunk` keys
    (whole rounds of a block) so that B * Hkv * row_tiles * splits
    approaches one wave of SMs where S_max allows."""
    row_tiles = -(-(hq // hkv) * n_tok // rows_per_tile)
    want = -(-_TARGET_BLOCKS // (batch * hkv * row_tiles))
    chunk = -(-s_max // want)
    chunk = -(-chunk // keys_per_round) * keys_per_round
    return row_tiles, -(-s_max // chunk), chunk


def decode_attention_cuda(q, k_cache, v_cache, cache_len):
    """Launch the Hopper kernel. q (B, T, Hq, D), k/v (B, S_max, Hkv, D),
    cache_len (B,) int32, all contiguous on one CUDA device; q/k/v float32 or
    bfloat16 of one dtype. Returns (B, T, Hq, D) in q's dtype."""
    global launch_count
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k_cache, v_cache)):
        raise RuntimeError("the decode-attention kernel has no backward; a training "
                           "forward takes ops.attention.mha")
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

    lib, tiles = _library()
    row_tiles, splits, chunk = plan_splits(b, t, hq, hkv, s_max, *tiles)
    groups = b * hkv * row_tiles
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((groups, splits, tiles[0], d), dtype=torch.float32, device=dev)
        part_ml = torch.empty((groups, splits, tiles[0], 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hv_decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        nvcc_build.ticket_buffer(dev, groups).data_ptr(),
        b, t, hq, hkv, d, s_max, splits, chunk,
        _SCALE_LOG2[d], stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode-attention kernel launch failed (code {rc})")
    launch_count += 1
    return out
