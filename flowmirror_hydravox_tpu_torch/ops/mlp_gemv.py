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
source.

`mlp_gemv` is the decode MLP of the port (every decode-step backbone block and
every MTP head): the kernel for a CUDA tensor, the plain version for a CPU
tensor. There is no fallback: a CUDA tensor launches the kernel or raises.
The kernel is built at first use (ops/nvcc_build.py) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import nvcc_build

KERNEL_SOURCE = nvcc_build.CSRC_DIR / "mlp_gemv.cu"
LIBRARY = nvcc_build.BUILD_DIR / "libhv_mlp_gemv.so"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Enough blocks to fill the H100's 132 SMs twice; pass 2 splits I to get there.
_TARGET_BLOCKS = 264

launch_count = 0  # kernel launches through mlp_gemv_cuda
_lib = None
_lib_lock = threading.Lock()


def mlp_gemv_ref(x, gate, up, down):
    """Plain version of the kernel's contract. x (M, H) -> (M, H) in x's dtype."""
    a = x.float() @ gate.float()
    b = x.float() @ up.float()
    h = (F.silu(a) * b).to(x.dtype)
    return (h.float() @ down.float()).to(x.dtype)


def build_library(force: bool = False):
    """Compile the kernel source into LIBRARY unless an up-to-date build exists."""
    return nvcc_build.build_library(KERNEL_SOURCE, LIBRARY, force)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.hv_mlp_gemv.restype = ctypes.c_int
            lib.hv_mlp_gemv.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            )
            for name in ("hv_mlp_gemv_cols_per_block", "hv_mlp_gemv_chunk",
                         "hv_mlp_gemv_rows_per_block"):
                getattr(lib, name).restype = ctypes.c_int
            _lib = lib
        return _lib


def plan_splits(m: int, hdim: int, idim: int, cols_per_block: int, chunk_rows: int,
                rows_per_block: int):
    """(splits, chunk): pass 2 cuts I into `splits` pieces of `chunk` rows of
    `down` (a multiple of the kernel's chunk depth) when the column tiles
    alone leave SMs idle."""
    base = -(-hdim // cols_per_block) * -(-m // rows_per_block)
    splits = 1
    if base < _TARGET_BLOCKS:
        splits = min(-(-_TARGET_BLOCKS // base), max(1, idim // chunk_rows))
    chunk = -(-idim // splits)
    chunk = -(-chunk // chunk_rows) * chunk_rows
    return -(-idim // chunk), chunk


def mlp_gemv_cuda(x, gate, up, down):
    """Launch the Hopper kernel. x (M, H), gate/up (H, I), down (I, H), all
    contiguous, 16-byte aligned, on one CUDA device and of one dtype (float32
    or bfloat16); M >= 1, I >= 1, H a multiple of 8. Returns (M, H) in x's
    dtype."""
    global launch_count
    if not x.is_cuda:
        raise ValueError("mlp_gemv_cuda needs CUDA tensors")
    for name, w in (("gate", gate), ("up", up), ("down", down)):
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in (gate, up, down)):
        raise TypeError(f"x/gate/up/down must share float32 or bfloat16, got "
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

    lib = _library()
    splits, chunk = plan_splits(m, hdim, idim, lib.hv_mlp_gemv_cols_per_block(),
                                lib.hv_mlp_gemv_chunk(), lib.hv_mlp_gemv_rows_per_block())
    ldh = -(-idim // 8) * 8
    h = torch.empty((m, ldh), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, m, hdim), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.hv_mlp_gemv(
        _DTYPES[x.dtype], x.data_ptr(), gate.data_ptr(), up.data_ptr(), down.data_ptr(),
        h.data_ptr(), part.data_ptr() if part is not None else None, out.data_ptr(),
        m, hdim, idim, ldh, splits, chunk, stream,
    )
    if rc != 0:
        raise RuntimeError(f"mlp-gemv kernel launch failed (code {rc})")
    launch_count += 1
    return out


def mlp_gemv(x, gate, up, down):
    """The decode MLP on rows (..., H): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    rows = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = mlp_gemv_cuda(rows.contiguous(), gate, up, down)
    elif x.device.type == "cpu":
        out = mlp_gemv_ref(rows, gate, up, down)
    else:
        raise ValueError(f"the MLP GEMV has no path for device {x.device}")
    return out.reshape(x.shape)
