"""The int8-weight form of the fused SwiGLU-MLP GEMV: its wrapper and
dispatch on the CPU, and the kernel against its plain version on the card.

This file imports no JAX, so the card tests also run on a machine without
it: `python -m pytest --noconftest tests/test_torch_kernels_int8.py -q`.
Card tolerance, as tests/test_torch_kernels.py holds the bf16 form: f32
1e-5, bf16 2e-2, relative to 1 + max |plain| (the kernel and the plain
version sum in another order, and bf16 rounds h); TF32 is off so f32 is
full f32."""

import ctypes
import struct

import pytest
import torch

from flowmirror_hydravox_tpu_torch.models import qwen2 as tq
from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as tmlp
from flowmirror_hydravox_tpu_torch.ops import quant

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (M, H, I): the backbone at one row, K 2 and 5, a row past a row group, the
# slots' verify block (20), the largest flash batch at K 5 (40) and past one
# block (65); the MTP width at the decode rows and the slots' head 0 (20);
# a ragged I (element loads); wider backbones, where a warp holds 8 tiles
# of H: Qwen2-1.5B's 1536 x 8960 at 8 and 16 rows a block, and the widest H
# the bf16 rows take (8-row blocks only)
CARD_CASES = [(m, 896, 4864) for m in (1, 2, 5, 9, 20, 40, 65)] + \
             [(m, 896, 22016) for m in (1, 4, 20)] + [(3, 896, 4863), (2, 64, 100)] + \
             [(2, 1536, 8960), (20, 1536, 8960), (9, tmlp.INT8_MAX_H, 8960)]


def _case(m, h, i, dtype=torch.float32, device="cpu", seed=0):
    """x (M, H) of `dtype`; int8 gate/up/down with their scales, from f32
    weights by the port's quantizer."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, h, generator=g, device=device).to(dtype)
    weights, scales = [], []
    for shape in ((h, i), (h, i), (i, h)):
        w8, s = quant.quantize_weight_int8(
            torch.randn(shape, generator=g, device=device) * 0.05)
        weights.append(w8)
        scales.append(s)
    return x, weights, tuple(scales)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_int8_dispatch_takes_the_plain_version_on_cpu():
    """On CPU tensors `mlp_gemv` with int8 weights is the plain int8 form,
    which equals the dense plain version on the dequantized weights within
    f32 rounding (the scales commute with the products); `decode_mlp`
    passes an int8 layer's scales."""
    x, (g, u, d), scales = _case(6, 64, 100)
    want = tmlp.mlp_gemv_ref(x, g, u, d, scales)
    got = tmlp.mlp_gemv(x.reshape(2, 3, 64), g, u, d, scales=scales)
    assert got.shape == (2, 3, 64)
    torch.testing.assert_close(got.reshape(6, 64), want, atol=0, rtol=0)
    dense = [w.float() * s for w, s in zip((g, u, d), scales)]
    torch.testing.assert_close(want, tmlp.mlp_gemv_ref(x, *dense), atol=2e-6, rtol=2e-5)
    layer = quant.quantize_layer_dict({"gate_proj_w": dense[0], "up_proj_w": dense[1],
                                       "down_proj_w": dense[2]})
    torch.testing.assert_close(tq.decode_mlp(layer, x),
                               tmlp.mlp_gemv_ref(x, *(layer[n] for n in quant.MLP_MATS),
                                                 quant.mlp_scales(layer)), atol=0, rtol=0)


def test_int8_wrapper_refuses_cpu_tensors_and_unpaired_scales(monkeypatch):
    """Also: the TMA descriptors a launch is handed stay alive when the
    lookup of the second empties a full cache (a stand-in for the library
    writes each weight's address and shape into its descriptor)."""
    x, (g, u, d), scales = _case(2, 64, 128)

    class Library:
        @staticmethod
        def hv_mlp_gemv_int8_tensor_map(out, ptr, rows, cols):
            ctypes.memmove(out, struct.pack("<Qii", ptr, rows, cols), 16)
            return 0

    monkeypatch.setattr(tmlp, "_library", lambda: (Library, None, None))
    monkeypatch.setattr(tmlp, "_tensor_maps", dict.fromkeys(range(tmlp._MAX_TENSOR_MAPS - 1)))
    maps = tmlp._tensor_maps_of(g, u)
    [ctypes.create_string_buffer(128) for _ in range(1000)]  # reuse any freed block
    assert [struct.unpack("<Qii", b.raw[:16]) for b in maps] == \
        [(w.data_ptr(), *w.shape) for w in (g, u)]
    assert list(tmlp._tensor_maps.values()) == maps  # the full cache was emptied first
    assert tmlp._tensor_maps_of(g, u) == maps  # and serves the next launch
    with pytest.raises(ValueError, match="CUDA"):
        tmlp.mlp_gemv_int8_cuda(x, g, u, d, scales)
    with pytest.raises(ValueError, match="scales"):  # int8 weights without scales
        tmlp.mlp_gemv(x, g, u, d)
    with pytest.raises(ValueError, match="scales"):  # scales with dense weights
        tmlp.mlp_gemv(x, g.float(), u.float(), d.float(), scales=scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_matches_plain_version_on_card(dtype):
    """Runs on the card only: the CUDA kernel has no CPU mode."""
    _needs_card()
    dt = getattr(torch, dtype)
    for k, (m, h, i) in enumerate(CARD_CASES):
        x, (g, u, d), scales = _case(m, h, i, dt, "cuda", seed=k)
        before = (tmlp.launch_count, tmlp.int8_launch_count)
        got = tmlp.mlp_gemv_int8_cuda(x, g, u, d, scales)
        torch.cuda.synchronize()
        assert (tmlp.launch_count, tmlp.int8_launch_count) == (before[0], before[1] + 1)
        assert got.dtype == dt and got.shape == x.shape
        want = tmlp.mlp_gemv_ref(x, g, u, d, scales).float()
        err = (got.float() - want).abs().max().item()
        assert err <= TOL[dt] * (1.0 + want.abs().max().item()), (m, h, i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_kernel_is_bit_reproducible_on_card(dtype):
    """The same inputs give the same output on every call (no float
    atomics), at one split of I and at several."""
    _needs_card()
    dt = getattr(torch, dtype)
    for m, h, i in ((2, 896, 4864), (20, 896, 22016), (5, 64, 128)):
        x, (g, u, d), scales = _case(m, h, i, dt, "cuda", seed=m)
        first = tmlp.mlp_gemv_int8_cuda(x, g, u, d, scales)
        assert torch.equal(tmlp.mlp_gemv_int8_cuda(x, g, u, d, scales), first), (m, h, i)


@pytest.mark.cuda
def test_int8_dispatch_launches_the_int8_form_on_card():
    """A CUDA tensor with int8 weights launches the int8 form (its own
    counter, not the bf16 form's) through `mlp_gemv` and `decode_mlp`."""
    _needs_card()
    x, (g, u, d), scales = _case(4, 896, 4864, torch.bfloat16, "cuda")
    layer = {"gate_proj_w": g, "up_proj_w": u, "down_proj_w": d,
             **{n + quant.SCALE_SUFFIX: s for n, s in zip(quant.MLP_MATS, scales)}}
    before = (tmlp.launch_count, tmlp.int8_launch_count)
    via_dispatch = tmlp.mlp_gemv(x.reshape(2, 2, 896), g, u, d, scales=scales)
    via_layer = tq.decode_mlp(layer, x)
    assert (tmlp.launch_count, tmlp.int8_launch_count) == (before[0], before[1] + 2)
    assert torch.equal(via_dispatch.reshape(4, 896), via_layer)


@pytest.mark.cuda
def test_int8_wrapper_refuses_bad_inputs_on_card():
    _needs_card()
    x, (g, u, d), scales = _case(2, 64, 128, torch.bfloat16, "cuda")
    with pytest.raises(TypeError):  # a bf16 weight among the int8 ones
        tmlp.mlp_gemv_int8_cuda(x, g, u.to(torch.bfloat16), d, scales)
    with pytest.raises(TypeError):  # int8 activations
        tmlp.mlp_gemv_int8_cuda(g, g, u, d, scales)
    with pytest.raises(ValueError):  # a scale missing
        tmlp.mlp_gemv_int8_cuda(x, g, u, d, scales[:2])
    with pytest.raises(ValueError):  # the down scale at I rather than H
        tmlp.mlp_gemv_int8_cuda(x, g, u, d, (scales[0], scales[1], scales[0]))
    with pytest.raises(TypeError):  # a bf16 scale
        tmlp.mlp_gemv_int8_cuda(x, g, u, d, (scales[0].bfloat16(), scales[1], scales[2]))
    with pytest.raises(ValueError):  # a strided weight
        tmlp.mlp_gemv_int8_cuda(x, g.t().contiguous().t(), u, d, scales)
    with pytest.raises(ValueError):  # a weight 8 bytes past a 16-byte boundary
        flat = torch.zeros(g.numel() + 8, dtype=torch.int8, device="cuda")
        tmlp.mlp_gemv_int8_cuda(x, flat[8:].view(g.shape), u, d, scales)
