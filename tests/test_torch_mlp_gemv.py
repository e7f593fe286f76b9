"""The fused SwiGLU-MLP GEMV's plain version against the TPU kernel it
replaces, `pallas_mlp_gemv` in interpret mode, and against the JAX
`qwen2._mlp_block`; and the decode route of the port's models.

Tolerances: f32 atol 2e-5 / rtol 2e-4 (summation order); bf16 atol 3e-2 /
rtol 6e-2, as tests/test_pallas_mlp.py holds the TPU kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import qwen2 as jq
from flowmirror_hydravox_tpu.ops.pallas_mlp import pallas_mlp_gemv
from flowmirror_hydravox_tpu_torch.models import qwen2 as tq
from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as tmlp
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import n, t, to_numpy_tree

F32 = dict(atol=2e-5, rtol=2e-4)
BF16 = dict(atol=3e-2, rtol=6e-2)


def _inputs(m, h, i, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((m, h))).astype(np.float32)
    ws = [(0.05 * rng.standard_normal(shape)).astype(np.float32)
          for shape in ((h, i), (h, i), (i, h))]
    return [x, *ws]


# the JAX references jitted: one compile per shape where the eager calls
# dispatched (and the interpreted kernel compiled) op by op
_JAX_KERNEL = jax.jit(lambda *a: pallas_mlp_gemv(*a, tile_i=256, interpret=True))
_JAX_BLOCK = jax.jit(jq._mlp_block)


# (M, H, I): one decode row, K rows, B 8 x K 5 rows, and the tiny config's
# MTP-head MLP width (22016) at B 3
@pytest.mark.parametrize("m,h,i", [(1, 64, 256), (5, 64, 512), (40, 64, 256), (3, 64, 22016)])
def test_plain_version_matches_pallas_kernel_and_mlp_block_f32(m, h, i):
    arrs = _inputs(m, h, i, seed=m + i)
    got = n(tmlp.mlp_gemv_ref(*map(t, arrs)))
    want_kernel = np.asarray(_JAX_KERNEL(*map(jnp.asarray, arrs)))
    x, g, u, d = map(jnp.asarray, arrs)
    want_block = np.asarray(_JAX_BLOCK({"gate_proj_w": g, "up_proj_w": u, "down_proj_w": d}, x))
    np.testing.assert_allclose(got, want_kernel, **F32)
    np.testing.assert_allclose(got, want_block, **F32)


def test_plain_version_matches_pallas_kernel_bf16():
    arrs = _inputs(4, 128, 512, seed=7)
    got = tmlp.mlp_gemv_ref(*(t(a).to(torch.bfloat16) for a in arrs))
    assert got.dtype == torch.bfloat16
    want = _JAX_KERNEL(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32), **BF16)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, g, u, d = map(t, _inputs(2, 64, 128, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        tmlp.mlp_gemv_cuda(x, g, u, d)


def test_decode_route_is_chosen_by_the_call_site(monkeypatch):
    """A decode-step block's MLP goes through `mlp_gemv` in every layer, a
    prefill block's never; the two routes agree with each other and with
    the JAX backbone."""
    cfg = tiny_config().llm.backbone
    jp = to_numpy_tree(jax.jit(lambda k: jq.init_params(k, cfg, jnp.float32))(  # not per op
        jax.random.PRNGKey(0)))
    tp = from_numpy_tree(jp, "cpu")
    calls = []

    def counting(x, gate, up, down):
        calls.append(tuple(x.shape))
        return tmlp.mlp_gemv(x, gate, up, down)

    monkeypatch.setattr(tq, "mlp_gemv", counting)
    x = np.random.default_rng(0).standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    cache = tq.init_kv_cache(cfg, 2, 256, dtype=torch.float32, device="cpu")
    cache = cache._replace(length=torch.tensor([4, 9], dtype=torch.int32))
    prefill, _ = tq.forward_block_with_cache(tp, cfg, t(x), cache)
    assert calls == []
    decode, _ = tq.forward_block_with_cache(tp, cfg, t(x), cache, decode_step=True)
    assert calls == [(2, 3, cfg.hidden_size)] * cfg.num_layers
    jcache = jq.init_kv_cache(cfg, 2, 256, dtype=jnp.float32)._replace(
        length=jnp.asarray([4, 9], jnp.int32))
    want, _ = jax.jit(lambda p, x, c: jq.forward_block_with_cache(p, cfg, x, c))(  # not per op
        jp, jnp.asarray(x), jcache)
    np.testing.assert_allclose(n(decode), n(prefill), **F32)
    np.testing.assert_allclose(n(decode), n(want), **F32)
