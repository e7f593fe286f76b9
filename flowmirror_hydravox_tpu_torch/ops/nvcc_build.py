"""Builds one CUDA source of `csrc/` into a shared library with a plain C
interface: `nvcc -gencode arch=compute_90a,code=sm_90a`, at first use, into
the gitignored `build/` of this package. The ops load the result with ctypes.

A library is rebuilt when its source, or any header beside it in `csrc/`
(`common.cuh`), is newer than it. Each build writes to a temporary name and
renames, so concurrent builds of one source are safe, and builds of
different sources run in parallel. The compiler's output (ptxas register
lines included) goes to `build/<source stem>.build.log`.

`ticket_buffer` holds the int32 tickets with which both kernels elect the
last block of a group to merge its partials.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_log(source: pathlib.Path) -> pathlib.Path:
    return BUILD_DIR / f"{source.stem}.build.log"


def is_stale(source: pathlib.Path, library: pathlib.Path) -> bool:
    """True when `library` is missing or older than `source` or any header
    (`*.cuh`, `*.h`) in the source's directory."""
    if not library.exists():
        return True
    inputs = [source, *source.parent.glob("*.cuh"), *source.parent.glob("*.h")]
    return library.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_library(source: pathlib.Path, library: pathlib.Path, force: bool = False) -> pathlib.Path:
    """Compile `source` into `library` unless an up-to-date build exists."""
    if not force and not is_stale(source, library):
        return library
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log(source).write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, library)
    return library


_tickets = {}


def ticket_buffer(device, n: int):
    """A zeroed int32 buffer of at least n tickets for `device`. A kernel
    leaves every ticket it takes at 0, so one buffer serves every launch on
    the device; the launches that use it must not overlap (the port's run
    on one stream, and each MLP pass 2 overlaps only its own pass 1, which
    takes no tickets)."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf
