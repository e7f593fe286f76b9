"""The Hopper kernels' wrappers and split plans, and each kernel against its
plain version on the card: decode attention and the fused SwiGLU-MLP GEMV.

This file imports no JAX, so the card tests also run on a machine without
it: `python -m pytest --noconftest tests/test_torch_kernels.py -q` (the
tests' conftest imports JAX). Card tolerance: f32 1e-5, bf16 2e-2, absolute
and relative (for the MLP: relative to 1 + max |plain|, as chip_smoke holds
it); TF32 is off so f32 is full f32."""

import os
import shutil

import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu_torch.ops import attention as tattn
from flowmirror_hydravox_tpu_torch.ops import decode_attention as tkern
from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as tmlp
from flowmirror_hydravox_tpu_torch.ops import nvcc_build

# main-path head layout (Hq 14, Hkv 2, D 64); cache_len at and around the
# 32-key tiles and 128-key splits; a prefill block; B 3 with per-row lengths
CARD_CASES = [(1, 1, 256, [63]), (1, 2, 512, [255]), (1, 5, 512, [300]), (1, 130, 256, [0]),
              (3, 2, 768, [5, 256, 700])]
# (B, T, S_max, cache_len, Hq) at the edges of the key-parallel design: G * T
# of 7, 14, 16 (Hq 16), 35 (4-row tiles, the last one partial) and a
# prefill of 130; the last key at the end of a 128-key split (a block's
# round) and one past it; rows with no key in the next split (T 5 at
# cache_len 509); the last key at S_max - T; a row with cache_len 0 in a
# batch of 3
EDGE_CASES = [(1, 1, 512, [200], 14), (1, 2, 1024, [511], 14), (1, 2, 512, [200], 16),
              (1, 5, 1024, [509], 14), (1, 130, 512, [0], 14), (1, 1, 512, [127], 14),
              (1, 1, 512, [128], 14), (1, 1, 1024, [512], 14), (1, 2, 512, [510], 14),
              (3, 2, 512, [0, 300, 77], 14)]


def _case(b, kblk, s_max, lens, dtype=torch.float32, device="cpu", seed=0, hq=14, d=64):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, kblk, hq, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, s_max, 2, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, s_max, 2, d, generator=g, device=device).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=device)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, cl = _case(1, 1, 64, [3])
    with pytest.raises(ValueError):
        tkern.decode_attention_cuda(q, k, v, cl)


def test_plain_version_masks_past_each_query():
    """Query t of row b sees keys <= cache_len[b] + t: keys past that can
    change freely without moving the output."""
    q, k, v, cl = _case(2, 3, 64, [5, 40])
    want = tkern.decode_attention_ref(q, k, v, cl)
    k2, v2 = k.clone(), v.clone()
    for row, c in enumerate(cl.tolist()):
        k2[row, c + 3:] = 7.0
        v2[row, c + 3:] = -7.0
    got = tkern.decode_attention_ref(q, k2, v2, cl)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # and the CPU dispatch is the plain version
    torch.testing.assert_close(tattn.decode_attention_dispatch(q, k, v, cl), want, atol=0, rtol=0)


@pytest.mark.parametrize("b,t_blk,hq,hkv,s_max", [
    (1, 1, 14, 2, 512), (1, 5, 14, 2, 768), (1, 2050, 14, 2, 2304), (3, 2, 14, 2, 256),
    (1, 2, 14, 2, 512), (1, 130, 14, 2, 512), (8, 5, 14, 2, 512), (1, 1, 4, 2, 100),
    (1, 2, 14, 2, 2304), (1, 1, 14, 2, 4096), (4, 2, 14, 2, 768), (4, 2, 14, 2, 1536),
    (1, 130, 14, 2, 768)])
def test_split_plan_covers_the_cache(b, t_blk, hq, hkv, s_max):
    row_tiles, splits, chunk = tkern.plan_splits(b, t_blk, hq, hkv, s_max, 4, 128)
    assert row_tiles * 4 >= (hq // hkv) * t_blk > (row_tiles - 1) * 4
    assert chunk % 128 == 0 and splits * chunk >= s_max > (splits - 1) * chunk
    blocks = b * hkv * row_tiles
    want = -(-132 // blocks)  # splits that would fill the SMs once
    if blocks >= 132:
        assert splits == 1
    else:  # the shortest chunk of whole rounds that gives at most `want` splits
        assert chunk == 128 or (chunk - 128) * want < s_max
    if (b, t_blk, s_max) == (1, 2, 512):  # the serving shape: 4 splits of 128
        assert (row_tiles, splits, chunk) == (4, 4, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(dtype):
    """Runs on the card only: the CUDA kernel has no CPU mode."""
    _needs_card()
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for i, (b, kblk, s_max, lens) in enumerate(CARD_CASES):
        q, k, v, cl = _case(b, kblk, s_max, lens, dt, "cuda", seed=i)
        before = tkern.launch_count
        got = tkern.decode_attention_cuda(q, k, v, cl)
        torch.cuda.synchronize()
        assert tkern.launch_count == before + 1
        assert got.dtype == dt and got.shape == q.shape
        want = tkern.decode_attention_ref(q, k, v, cl)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_at_tiny_head_dim_on_card(dtype):
    """tiny_config()'s head layout (Hq 4, Hkv 2, D 16), as `--tiny --device
    cuda` runs it; the card only."""
    _needs_card()
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for i, (b, kblk, s_max, lens) in enumerate(CARD_CASES):
        q, k, v, cl = _case(b, kblk, s_max, lens, dt, "cuda", seed=i, hq=4, d=16)
        got = tkern.decode_attention_cuda(q, k, v, cl)
        want = tkern.decode_attention_ref(q, k, v, cl)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_build_is_stale_when_a_header_changes(tmp_path):
    """A library is rebuilt when its source or a header beside it is newer."""
    csrc = tmp_path / "csrc"
    shutil.copytree(nvcc_build.CSRC_DIR, csrc)
    source, header = csrc / "decode_attention.cu", csrc / "common.cuh"
    library = tmp_path / "lib.so"
    assert nvcc_build.is_stale(source, library)  # no library yet
    library.write_bytes(b"")
    now = max(source.stat().st_mtime, header.stat().st_mtime)
    os.utime(library, (now + 10, now + 10))
    assert not nvcc_build.is_stale(source, library)
    os.utime(header, (now + 20, now + 20))
    assert nvcc_build.is_stale(source, library)
    os.utime(library, (now + 30, now + 30))
    os.utime(source, (now + 40, now + 40))
    assert nvcc_build.is_stale(source, library)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_edge_cases_on_card(dtype):
    """The key-parallel design's edges: row tiles, split boundaries, a
    cache_len 0 row, a prefill; the card only."""
    _needs_card()
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for i, (b, kblk, s_max, lens, hq) in enumerate(EDGE_CASES):
        q, k, v, cl = _case(b, kblk, s_max, lens, dt, "cuda", seed=10 + i, hq=hq)
        got = tkern.decode_attention_cuda(q, k, v, cl)
        want = tkern.decode_attention_ref(q, k, v, cl).float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * (1.0 + want.abs().max().item()), (b, kblk, s_max, lens, hq, err)


# (B, T, S_max, cache_len): a continuous-batching slot step, 4 slots at K 2,
# against the cache of --max-tokens 300 (768 rows) and of the default 1024
# (1536 rows), with an empty slot (cache_len 0) and a slot at S_max - T
SLOT_CASES = [(4, 2, 768, [0, 37, 300, 766]), (4, 2, 1536, [0, 130, 900, 1534])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_slot_shapes_on_card(dtype):
    """The continuous slots' decode step; the card only."""
    _needs_card()
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for i, (b, kblk, s_max, lens) in enumerate(SLOT_CASES):
        q, k, v, cl = _case(b, kblk, s_max, lens, dt, "cuda", seed=30 + i)
        got = tkern.decode_attention_cuda(q, k, v, cl)
        want = tkern.decode_attention_ref(q, k, v, cl).float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * (1.0 + want.abs().max().item()), (b, kblk, s_max, lens, err)
        assert torch.equal(tkern.decode_attention_cuda(q, k, v, cl), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_are_bit_reproducible_on_card(dtype):
    """Two calls on the same inputs give identical outputs (no float
    atomics; the ticketed merges sum in split order), for both kernels."""
    _needs_card()
    dt = getattr(torch, dtype)
    for b, kblk, s_max, lens, hq in EDGE_CASES:
        q, k, v, cl = _case(b, kblk, s_max, lens, dt, "cuda", hq=hq)
        first = tkern.decode_attention_cuda(q, k, v, cl)
        assert torch.equal(tkern.decode_attention_cuda(q, k, v, cl), first)
    for m, h, i in MLP_CARD_CASES:
        x, g, u, d = _mlp_case(m, h, i, dt, "cuda")
        first = tmlp.mlp_gemv_cuda(x, g, u, d)
        assert torch.equal(tmlp.mlp_gemv_cuda(x, g, u, d), first)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_inputs_on_card():
    _needs_card()
    q, k, v, cl = _case(1, 2, 256, [10], torch.float32, "cuda")
    with pytest.raises(TypeError):  # mixed dtypes
        tkern.decode_attention_cuda(q, k.to(torch.bfloat16), v, cl)
    with pytest.raises(TypeError):  # int64 lengths
        tkern.decode_attention_cuda(q, k, v, cl.long())
    with pytest.raises(ValueError):  # not contiguous
        tkern.decode_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, cl)
    with pytest.raises(ValueError):  # unsupported head dim
        tkern.decode_attention_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                    v[..., :48].contiguous(), cl)
    assert np.isfinite(tkern.decode_attention_cuda(q, k, v, cl).cpu().numpy()).all()


# (M, H, I): the backbone decode MLP (896 x 4864) at M = B x K rows, the MTP
# heads (896 x 22016) at M = B, tiny_config()'s 64 x 128, and edges: each
# row-group size and one past it (8, 9, 16, 40, 65: more rows than one
# block holds), a ragged I (4864 + 8, odd 4863, 100)
MLP_CARD_CASES = [(1, 896, 4864), (2, 896, 4864), (5, 896, 4864), (10, 896, 4864),
                  (40, 896, 4864), (1, 896, 22016), (4, 896, 22016), (8, 896, 22016),
                  (3, 64, 128), (70, 64, 128), (3, 64, 100), (8, 896, 4864), (9, 896, 4864),
                  (16, 896, 4864), (65, 896, 4864), (2, 896, 4872), (3, 896, 4863)]


def _mlp_case(m, h, i, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, h, generator=g, device=device)
    ws = [torch.randn(shape, generator=g, device=device) * 0.05 for shape in ((h, i), (h, i), (i, h))]
    return [t.to(dtype) for t in [x, *ws]]


@pytest.mark.parametrize("m,h,i", [(1, 896, 4864), (40, 896, 4864), (8, 896, 22016),
                                   (3, 64, 128), (70, 64, 128), (65, 896, 4864),
                                   (2, 896, 4872), (3, 896, 4863), (1, 896, 22016)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_split_plan_covers_i(m, h, i, dtype):
    groups = tmlp._ROW_GROUPS[getattr(torch, dtype)]
    cols = tuple(64 if g <= 2 else 32 for g in groups)  # the kernel's column tiles
    mg, row_blocks, splits, chunk = tmlp.plan_splits(m, h, i, groups, cols, 16)
    assert mg in groups and row_blocks * 8 * mg >= m > (row_blocks - 1) * 8 * mg
    if m <= 8 * groups[-1]:
        assert row_blocks == 1  # the weights are read once
    assert chunk % 16 == 0 and chunk <= 1024
    assert splits * chunk >= i > (splits - 1) * chunk
    tiles = -(-h // cols[groups.index(mg)]) * row_blocks
    # about the target: rounding the chunk to the k-step costs at most a split
    target = tmlp._TARGET_BLOCKS[mg]
    assert tiles * (splits + 1) >= min(target, tiles * -(-i // 16))
    if (m, h, i, dtype) == (40, 896, 4864, "bfloat16"):  # 7 splits, as measured best
        assert (mg, splits) == (5, 7)
    if dtype == "bfloat16":  # bf16 rows take the int8 form's one launch
        # at this H, at Qwen2-1.5B's 1536 (8 tiles of H a warp) and at the
        # widest H the form takes (8-row blocks only)
        for width in (h, 1536, tmlp.INT8_MAX_H):
            _check_int8_plan(m, width, i)


# clusters of the int8 form that fit at once on an H100 80GB HBM3, by the
# blocks an SM holds and the cluster size (cudaOccupancyMaxActiveClusters,
# the "int8 resident clusters" line of chip_smoke.py): clusters of 4 and 8
# fit on 120 of the 132 SMs
_H100_CLUSTERS = {1: {1: 132, 2: 66, 4: 30, 8: 15}, 2: {1: 264, 2: 132, 4: 62, 8: 30}}


def _h100_resident(row_groups, hdim, smem, cluster):
    """Clusters of the int8 form resident at once on the H100: two blocks an
    SM at most at one row group up to H 1024, else one (the kernel's launch
    bounds), as 228 KB of shared memory an SM allows (1 KB of it a block's
    reserve)."""
    per_sm = min(2 if row_groups == 1 and hdim <= 1024 else 1, 233472 // (smem + 1024))
    return _H100_CLUSTERS[per_sm][cluster]


def _check_int8_plan(m, h, i):
    """The int8 form's plan: its chunks cover I exactly once, a block's
    shared memory fits, every block is resident at once, and at the served
    widths the grid has at least a block for each of the 132 SMs (which SMs
    a cluster of 8 lands on is the card's choice: they fit on 120)."""
    plan = tmlp.plan_int8(m, h, i, _h100_resident)
    assert plan.stages in (1, 2)
    # the fewest groups of 8 rows that hold min(M, 16), only 8 rows past H
    # 1664, where a stage of 16 does not fit; or 24 rows past 16, up to H
    # 1024, where its blocks walk fewer chunks (at M 40 x 4864 they do not)
    low = 1 if h > 1664 else -(-min(m, 16) // 8)
    assert plan.row_groups == low or (plan.row_groups == 3 and m > 16 and h <= 1024)
    if h == 896 and i == 4864 and m in (40, 65):
        assert plan.row_groups == {40: 2, 65: 3}[m]
    rows = 8 * plan.row_groups
    assert plan.row_blocks * rows >= m > (plan.row_blocks - 1) * rows
    assert plan.smem == tmlp.int8_smem_bytes(h, plan.row_groups, plan.stages) <= 232448
    assert plan.cluster in tmlp.INT8_CLUSTERS and plan.blocks % plan.cluster == 0
    clusters = plan.blocks // plan.cluster * plan.row_blocks
    assert clusters <= _h100_resident(plan.row_groups, h, plan.smem, plan.cluster)
    # block b walks chunks b, b + blocks, ... (the kernel's order)
    n = -(-i // tmlp.INT8_CHUNK)
    cols = [c for b in range(plan.blocks) for k in range(b, n, plan.blocks)
            for c in range(k * tmlp.INT8_CHUNK, min(i, (k + 1) * tmlp.INT8_CHUNK))]
    assert sorted(cols) == list(range(i))
    if h == 896 and i in (4864, 22016) and m <= 16:
        assert plan.blocks * plan.row_blocks >= 132


def test_mlp_dispatch_takes_the_plain_version_on_cpu():
    x, g, u, d = _mlp_case(6, 64, 128)
    want = tmlp.mlp_gemv_ref(x, g, u, d)
    got = tmlp.mlp_gemv(x.reshape(2, 3, 64), g, u, d)
    assert got.shape == (2, 3, 64)
    torch.testing.assert_close(got.reshape(6, 64), want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_kernel_matches_plain_version_on_card(dtype):
    """Runs on the card only: the CUDA kernel has no CPU mode."""
    _needs_card()
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for k, (m, h, i) in enumerate(MLP_CARD_CASES):
        x, g, u, d = _mlp_case(m, h, i, dt, "cuda", seed=k)
        before = tmlp.launch_count
        got = tmlp.mlp_gemv_cuda(x, g, u, d)
        torch.cuda.synchronize()
        assert tmlp.launch_count == before + 1
        assert got.dtype == dt and got.shape == x.shape
        want = tmlp.mlp_gemv_ref(x, g, u, d).float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * (1.0 + want.abs().max().item()), (m, h, i, err)
        # the same inputs give the same output on every run (no float atomics)
        assert torch.equal(tmlp.mlp_gemv_cuda(x, g, u, d), got)


@pytest.mark.cuda
def test_mlp_kernel_wrapper_refuses_bad_inputs_on_card():
    _needs_card()
    x, g, u, d = _mlp_case(2, 64, 128, torch.float32, "cuda")
    with pytest.raises(TypeError):  # mixed dtypes
        tmlp.mlp_gemv_cuda(x, g.to(torch.bfloat16), u, d)
    with pytest.raises(ValueError):  # not contiguous
        tmlp.mlp_gemv_cuda(x, g.t().contiguous().t(), u, d)
    with pytest.raises(ValueError):  # H not a multiple of 8
        tmlp.mlp_gemv_cuda(x[:, :60].contiguous(), g[:60].contiguous(), u[:60].contiguous(),
                           d[:, :60].contiguous())
    with pytest.raises(ValueError):  # down of the wrong shape
        tmlp.mlp_gemv_cuda(x, g, u, d[:64].contiguous())
