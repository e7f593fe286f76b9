"""Fused SwiGLU-MLP GEMV for decode rows: the Hopper kernel and its plain
PyTorch version.

`mlp_gemv_cuda` launches `csrc/mlp_gemv.cu`, the hand-written replacement for
the TPU kernel `flowmirror_hydravox_tpu/ops/pallas_mlp.py::pallas_mlp_gemv`.
The contract is that kernel's (`_mlp_kernel`):

    out = (silu(x @ gate) * (x @ up)) @ down

with x (M, H), gate and up (H, I), down (I, H) in JAX's (in, out) layout,
one dtype (float32 or bfloat16) for all four. Both products of x are
accumulated in f32, `h` is rounded to x's dtype before the down product,
which is accumulated in f32, and the output is cast to x's dtype. It is
bound by bytes on the card (the weights over 3.35 TB/s); see the note in the
source. Two launches per call; the splits of I are summed by the last block
of each column tile, elected by an integer ticket in a per-device buffer that
the kernel leaves zeroed, so calls on one device must share one stream (the
port's do).

`mlp_gemv_int8_cuda` launches the kernel's int8-weight form, for the trees
of weight-only int8 (ops/quant.py): gate, up and down int8 with their f32
per-output-column scales (s_g, s_u, s_d), x float32 or bfloat16:

    a = (x @ g8) * s_g;  b = (x @ u8) * s_u      (f32 sums)
    out = round_T((round_T(silu(a) * b) @ d8) * s_d)

This is the JAX `_mlp_block` over `matmul_q` (qwen2.py:110-112,
llm.py:94-96), which rounds each product to x's dtype before its scale;
the kernel rounds only h and the output. It has a launch counter of its
own, `int8_launch_count`. For bfloat16 rows it is one launch: blocks take
32-column chunks of I, stream their gate, up and down bytes into shared
memory by the TMA, keep h there, and sum their partials of the output
inside thread block clusters and then across them (see the note in the
source). `plan_int8` plans that launch from the shapes; the TMA
descriptors of gate and up are built once per weight tensor. float32 rows
take two launches, as the dense form does.

`mlp_gemv` is the decode MLP of the port (every decode-step backbone block and
every MTP head): the kernel for a CUDA tensor, the plain version for a CPU
tensor, the int8 form when the weights are int8 (`scales` given). There is no
fallback: a CUDA tensor launches the kernel or raises. The kernel is built at
first use (ops/nvcc_build.py) and loaded with ctypes.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import nvcc_build

KERNEL_SOURCE = nvcc_build.CSRC_DIR / "mlp_gemv.cu"
LIBRARY = nvcc_build.BUILD_DIR / "libhv_mlp_gemv.so"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows of x a block holds, in groups of 8 (the kernel's instantiations):
# bf16 up to 40 rows (B 8 x K 5), f32 up to 16; more take further row blocks
_ROW_GROUPS = {torch.float32: (1, 2), torch.bfloat16: (1, 2, 5)}
# pass 2 splits I until its blocks fill the H100's 132 SMs about once (at
# 5 row groups, whose blocks take 32 columns, about 1.5 times: 7 splits of
# I 4864 rather than 5 ran faster at M 24-40 on the H100), and into pieces
# of at most _MAX_CHUNK rows (the staged h rows)
_TARGET_BLOCKS = {1: 132, 2: 132, 5: 196}
_MAX_CHUNK = 1024

# the int8 form's launch for bf16 rows (csrc/mlp_gemv.cu, int8_mlp_kernel):
# 32-column chunks of I, clusters of up to 8 blocks, and the dynamic shared
# memory a block may take (the H100's 227 KB less the 1 KB the kernel's
# static shared memory may need); INT8_MAX_H, below, the widest H it takes
INT8_CHUNK = 32
INT8_CLUSTERS = (8, 4, 2, 1)
INT8_MAX_SMEM = 232448 - 1024

launch_count = 0  # kernel launches through mlp_gemv_cuda
int8_launch_count = 0  # launches of the int8 form, through mlp_gemv_int8_cuda
_lib = None
_lib_lock = threading.Lock()


def mlp_gemv_ref(x, gate, up, down, scales=None):
    """Plain version of the kernel's contract. x (M, H) -> (M, H) in x's
    dtype; with `scales` (s_g, s_u, s_d), the int8 form's."""
    s_g, s_u, s_d = ((s.reshape(-1).float() for s in scales) if scales is not None
                     else (1.0, 1.0, 1.0))
    a = (x.float() @ gate.float()) * s_g
    b = (x.float() @ up.float()) * s_u
    h = (F.silu(a) * b).to(x.dtype)
    return ((h.float() @ down.float()) * s_d).to(x.dtype)


def build_library(force: bool = False):
    """Compile the kernel source into LIBRARY unless an up-to-date build exists."""
    return nvcc_build.build_library(KERNEL_SOURCE, LIBRARY, force)


def _library():
    """The loaded library and its tile sizes, read once: per dtype, the
    columns a block takes at each of its row-group counts; the rows of a
    k-step."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.hv_mlp_gemv.restype = ctypes.c_int
            lib.hv_mlp_gemv.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            )
            lib.hv_mlp_gemv_int8_f32.restype = ctypes.c_int
            lib.hv_mlp_gemv_int8_f32.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            )
            lib.hv_mlp_gemv_int8.restype = ctypes.c_int
            lib.hv_mlp_gemv_int8.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            )
            lib.hv_mlp_gemv_int8_tensor_map.restype = ctypes.c_int
            lib.hv_mlp_gemv_int8_tensor_map.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            lib.hv_mlp_gemv_int8_resident.restype = ctypes.c_int
            lib.hv_mlp_gemv_int8_resident.argtypes = [ctypes.c_int] * 4
            lib.hv_mlp_gemv_cols_per_block.restype = ctypes.c_int
            lib.hv_mlp_gemv_cols_per_block.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.hv_mlp_gemv_k_step.restype = ctypes.c_int
            cols = {dt: tuple(lib.hv_mlp_gemv_cols_per_block(code, g) for g in _ROW_GROUPS[dt])
                    for dt, code in _DTYPES.items()}
            _lib = lib, cols, lib.hv_mlp_gemv_k_step()
        return _lib


@functools.lru_cache(maxsize=256)
def plan_splits(m: int, hdim: int, idim: int, row_groups: tuple, cols_per_block: tuple,
                k_step: int):
    """(row_groups, row_blocks, splits, chunk): a block holds 8 * g rows of
    x, g the fewest of `row_groups` that hold min(M, the most), and the
    matching entry of `cols_per_block` columns; pass 2 cuts I into `splits`
    pieces of `chunk` rows of `down` (a multiple of the k-step, at most
    _MAX_CHUNK) until its column tiles times splits reach the target number
    of blocks."""
    rows = min(m, 8 * row_groups[-1])
    k = next(k for k, g in enumerate(row_groups) if 8 * g >= rows)
    row_blocks = -(-m // (8 * row_groups[k]))
    base = -(-hdim // cols_per_block[k]) * row_blocks
    splits = max(-(-_TARGET_BLOCKS[row_groups[k]] // base), -(-idim // _MAX_CHUNK))
    chunk = -(-idim // min(splits, -(-idim // k_step)))
    chunk = -(-chunk // k_step) * k_step
    return row_groups[k], row_blocks, -(-idim // chunk), chunk


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def int8_smem_bytes(hdim: int, row_groups: int, stages: int) -> int:
    """Dynamic shared memory of a block of the int8 form: the `total` of
    csrc/mlp_gemv.cu's Int8Layout (the kernel refuses any other figure).
    Per stage, gate and up [hpad][32] (at least the warps' f32 sums of them)
    and down's 32 rows at a stride of round_up(H, 128) + 16 bytes, each
    stage in whole KB; then x and h in bf16, s_d's range in f32, nine
    mbarriers a stage and 1 KB to align the base."""
    hpad = 8 * 16 * -(-hdim // (16 * 8))  # 8 warps' pieces of whole k-steps
    gu = max(2 * hpad * INT8_CHUNK, 8 * 2 * 8 * row_groups * (INT8_CHUNK + 8) * 4)
    stage = _round_up(gu + INT8_CHUNK * (_round_up(hdim, 128) + 16), 1024)
    hs = stages * stage + 8 * row_groups * (_round_up(hdim, 16) + 8) * 2
    sds = hs + 8 * row_groups * (INT8_CHUNK + 8) * 2
    return _round_up(sds + 4 * hdim, 8) + stages * 9 * 8 + 1024


# the widest H of the int8 form's bf16 rows: one stage of an 8-row block
# fits (1920), within the kernel's 2048
INT8_MAX_H = max(h for h in range(8, 2049, 8) if int8_smem_bytes(h, 1, 1) <= INT8_MAX_SMEM)

Int8Plan = collections.namedtuple("Int8Plan", "row_groups row_blocks blocks cluster stages smem")


@functools.lru_cache(maxsize=256)
def plan_int8(m: int, hdim: int, idim: int, resident) -> Int8Plan:
    """The int8 form's launch for bf16 rows (H at most INT8_MAX_H). A block
    holds 8 * row_groups rows; more rows take further row blocks. Block b
    of `blocks` takes the 32-column chunks b, b + blocks, ... of I, through
    `stages` stages of `smem` bytes; blocks come in clusters of `cluster`.
    `resident(row_groups, hdim, smem, cluster)` is the number of such
    clusters that fit on the card at once, and every plan fits in one wave.
    Row groups: the fewest that hold min(M, 16) rows, and past 16 rows also
    3 (24 rows, built up to H 1024), each where a stage of them fits; of the
    two, the plan whose blocks walk the fewest chunks, a chunk counting 1.5
    where one stage leaves the next chunk's loads behind its math (as
    development runs on the H100 read M 17-65 at I 4864 and 22016), the
    larger blocks on a tie."""
    n = -(-idim // INT8_CHUNK)
    fits = [g for g in ((1, 2, 3) if hdim <= 1024 else (1, 2))
            if int8_smem_bytes(hdim, g, 1) <= INT8_MAX_SMEM]
    low = min((g for g in fits if 8 * g >= min(m, 16)), default=fits[-1])

    def cost(p):
        k = -(-n // p.blocks)  # chunks of the busiest block
        return k * (3 if p.stages == 1 and k > 1 else 2), -p.row_groups

    return min((_plan_int8_at(g, m, hdim, n, resident) for g in fits
                if g == low or (g == 3 and m > 16)), key=cost)


def _plan_int8_at(mg: int, m: int, hdim: int, n: int, resident) -> Int8Plan:
    """plan_int8's launch at `mg` row groups, over `n` chunks: of the plans,
    the one with the largest cluster among those that keep at least nine
    tenths of the most blocks any plan keeps (each cluster adds a partial
    to the last sum across clusters, a chain of round trips to L2 that
    outweighs the few SMs a cluster of 8 may leave idle); then the most
    blocks; then, where a block walks several chunks, two stages."""
    row_blocks = -(-m // (8 * mg))
    plans = []
    for stages in (1, 2):
        smem = int8_smem_bytes(hdim, mg, stages)
        if smem > INT8_MAX_SMEM:
            continue
        for cl in (c for c in INT8_CLUSTERS if c <= n or c == 1):
            blocks = min(resident(mg, hdim, smem, cl) * cl // row_blocks // cl * cl,
                         _round_up(n, cl))
            if blocks:
                plans.append(Int8Plan(mg, row_blocks, blocks, cl, stages, smem))
    if not plans:  # more row blocks than fit at once: they take turns
        return Int8Plan(mg, row_blocks, 1, 1, 1, int8_smem_bytes(hdim, mg, 1))
    most = max(p.blocks for p in plans)
    return max((p for p in plans if 10 * p.blocks >= 9 * most),
               key=lambda p: (p.cluster, p.blocks, p.stages if p.blocks < n else -p.stages))


_resident_counts = {}
_tensor_maps = {}


def _resident(row_groups: int, hdim: int, smem: int, cluster: int) -> int:
    """Clusters of the int8 form that fit on the card at once (read once per
    launch shape from the CUDA occupancy API)."""
    key = (row_groups, hdim, smem, cluster)
    if key not in _resident_counts:
        n = _library()[0].hv_mlp_gemv_int8_resident(row_groups, hdim, smem, cluster)
        if n < 0:
            raise RuntimeError(f"mlp-gemv int8 occupancy query failed (code {-n})")
        _resident_counts[key] = n
    return _resident_counts[key]


_MAX_TENSOR_MAPS = 4096


def _tensor_maps_of(*weights):
    """The TMA descriptors of `weights` (gate and up), as 128-byte buffers
    that the caller holds until its launch returns. A descriptor depends
    only on the address and the shape, so one built for a weight serves
    every call on it (the weights live as long as the engine) and stays
    right if the memory is reused. Reloaded weights leave old addresses
    behind: the cache is emptied before a lookup that could fill it, never
    between the lookups of one launch, and a buffer dropped from it lives on
    in the caller's hands."""
    if len(_tensor_maps) + len(weights) > _MAX_TENSOR_MAPS:
        _tensor_maps.clear()
    bufs = []
    for w in weights:
        key = (w.data_ptr(), *w.shape)
        buf = _tensor_maps.get(key)
        if buf is None:
            buf = ctypes.create_string_buffer(128)
            rc = _library()[0].hv_mlp_gemv_int8_tensor_map(ctypes.addressof(buf), w.data_ptr(),
                                                           *w.shape)
            if rc != 0:
                raise RuntimeError(f"mlp-gemv int8 tensor map failed (code {rc})")
            _tensor_maps[key] = buf
        bufs.append(buf)
    return bufs


def _check(x, gate, up, down, weight_dtype):
    """The inputs the kernel takes, else raise. Returns (M, H, I)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gate, up, down)):
        raise RuntimeError("the MLP GEMV kernel has no backward; a training forward "
                           "takes qwen2._mlp_block")
    if not x.is_cuda:
        raise ValueError("the MLP GEMV kernel needs CUDA tensors")
    for name, w in (("gate", gate), ("up", up), ("down", down)):
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")
    want = x.dtype if weight_dtype is None else weight_dtype
    if x.dtype not in _DTYPES or any(w.dtype != want for w in (gate, up, down)):
        raise TypeError(f"x must be float32 or bfloat16 and gate/up/down {want}, got "
                        f"{x.dtype}/{gate.dtype}/{up.dtype}/{down.dtype}")
    if x.dim() != 2 or gate.dim() != 2:
        raise ValueError(f"bad shapes x {tuple(x.shape)} gate {tuple(gate.shape)}")
    m, hdim = x.shape
    idim = gate.shape[1]
    if (m < 1 or idim < 1 or gate.shape != (hdim, idim) or up.shape != (hdim, idim)
            or down.shape != (idim, hdim)):
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)} gate {tuple(gate.shape)} "
                         f"up {tuple(up.shape)} down {tuple(down.shape)}")
    if hdim % 8:
        raise ValueError(f"H = {hdim} must be a multiple of 8")
    for name, t in (("x", x), ("gate", gate), ("up", up), ("down", down)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return m, hdim, idim


def _launch(entry, x, gate, up, down, scale_ptrs, m, hdim, idim):
    lib, cols, k_step = _library()
    groups, cols = _ROW_GROUPS[x.dtype], cols[x.dtype]
    mg, row_blocks, splits, chunk = plan_splits(m, hdim, idim, groups, cols, k_step)
    tiles = -(-hdim // cols[groups.index(mg)])  # pass 2's column tiles, one ticket each
    ldh = -(-idim // 8) * 8
    h = torch.empty((m, ldh), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, m, hdim), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, entry)(
        _DTYPES[x.dtype], x.data_ptr(), gate.data_ptr(), up.data_ptr(), down.data_ptr(),
        *scale_ptrs, h.data_ptr(), part.data_ptr() if part is not None else None,
        nvcc_build.ticket_buffer(x.device, row_blocks * tiles).data_ptr(), out.data_ptr(),
        m, hdim, idim, ldh, mg, splits, chunk, stream,
    )
    if rc != 0:
        raise RuntimeError(f"mlp-gemv kernel launch failed (code {rc})")
    return out


def mlp_gemv_cuda(x, gate, up, down):
    """Launch the Hopper kernel. x (M, H), gate/up (H, I), down (I, H), all
    contiguous, 16-byte aligned, on one CUDA device and of one dtype (float32
    or bfloat16); M >= 1, I >= 1, H a multiple of 8. Returns (M, H) in x's
    dtype."""
    global launch_count
    m, hdim, idim = _check(x, gate, up, down, None)
    out = _launch("hv_mlp_gemv", x, gate, up, down, (), m, hdim, idim)
    launch_count += 1
    return out


def _launch_int8(x, gate, up, down, scale_ptrs, m, hdim, idim):
    lib = _library()[0]
    plan = plan_int8(m, hdim, idim, _resident)
    tma = hdim % 16 == 0 and idim % 16 == 0  # the TMA's 16-byte strides and sizes
    maps = _tensor_maps_of(gate, up) if tma else []  # held until the launch returns
    clusters = plan.blocks // plan.cluster
    part = (torch.empty((clusters, m, hdim), dtype=torch.float32, device=x.device)
            if clusters > 1 else None)
    out = torch.empty_like(x)
    tickets = nvcc_build.ticket_buffer(x.device, plan.row_blocks * plan.cluster)
    rc = lib.hv_mlp_gemv_int8(
        *([ctypes.addressof(b) for b in maps] or [None, None]), x.data_ptr(), gate.data_ptr(),
        up.data_ptr(), down.data_ptr(), *scale_ptrs,
        part.data_ptr() if part is not None else None, tickets.data_ptr(), out.data_ptr(),
        m, hdim, idim, plan.row_groups, plan.blocks, plan.cluster, plan.stages, plan.smem,
        int(tma), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mlp-gemv int8 kernel launch failed (code {rc})")
    return out


def mlp_gemv_int8_cuda(x, gate, up, down, scales):
    """Launch the kernel's int8 form. x (M, H) float32 or bfloat16 (H at
    most INT8_MAX_H for bfloat16); gate/up (H, I), down (I, H) int8, contiguous
    and 16-byte aligned; `scales` (s_g, s_u, s_d) f32 on x's device,
    contiguous, of I, I and H elements ((1, O) or (O,)). Returns (M, H) in
    x's dtype."""
    global int8_launch_count
    m, hdim, idim = _check(x, gate, up, down, torch.int8)
    if scales is None or len(scales) != 3:
        raise ValueError("the int8 form needs the (gate, up, down) scales")
    for name, s, n in zip(("s_g", "s_u", "s_d"), scales, (idim, idim, hdim)):
        if s.dtype != torch.float32 or s.device != x.device:
            raise TypeError(f"{name} must be float32 on {x.device}, got {s.dtype} on {s.device}")
        if s.numel() != n or s.shape[-1] != n or not s.is_contiguous():
            raise ValueError(f"{name} must be {n} contiguous scales, got {tuple(s.shape)}")
    scale_ptrs = [s.data_ptr() for s in scales]
    if x.dtype == torch.bfloat16:
        if hdim > INT8_MAX_H:
            raise ValueError(f"the int8 form takes H up to {INT8_MAX_H} for bfloat16 rows, "
                             f"got {hdim}")
        out = _launch_int8(x, gate, up, down, scale_ptrs, m, hdim, idim)
    else:
        out = _launch("hv_mlp_gemv_int8_f32", x, gate, up, down, scale_ptrs, m, hdim, idim)
    int8_launch_count += 1
    return out


def mlp_gemv(x, gate, up, down, scales=None):
    """The decode MLP on rows (..., H): the kernel for CUDA tensors, the plain
    version for CPU tensors; the int8 form when the weights are int8, which
    then need their `scales` (s_g, s_u, s_d)."""
    rows = x.reshape(-1, x.shape[-1])
    quantized = gate.dtype == torch.int8
    if quantized != (scales is not None):
        raise ValueError("int8 weights take their scales, and only int8 weights do")
    if x.is_cuda:
        out = (mlp_gemv_int8_cuda(rows.contiguous(), gate, up, down, scales) if quantized
               else mlp_gemv_cuda(rows.contiguous(), gate, up, down))
    elif x.device.type == "cpu":
        out = mlp_gemv_ref(rows, gate, up, down, scales)
    else:
        raise ValueError(f"the MLP GEMV has no path for device {x.device}")
    return out.reshape(x.shape)
