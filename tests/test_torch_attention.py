"""Port rope / attention ops against the JAX package (the kernel's own tests,
which need no JAX, are in test_torch_kernels.py).

CPU tolerance: f32, atol 2e-5 / rtol 2e-4 (summation order differs between
XLA and PyTorch; the JAX kernel test uses the same bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.ops import attention as jattn
from flowmirror_hydravox_tpu.ops import rope as jrope
from flowmirror_hydravox_tpu.ops.pallas_attention import pallas_decode_attention
from flowmirror_hydravox_tpu_torch.ops import attention as tattn
from flowmirror_hydravox_tpu_torch.ops import rope as trope
from tests.torch_port_util import n, t

TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("layout", ["halved", "interleaved"])
def test_rope_matches_jax(layout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = trope.rope_cos_sin(t(pos), 16, 10000.0)
    np.testing.assert_allclose(n(tc), n(jc), atol=1e-6)
    np.testing.assert_allclose(n(ts), n(js), atol=1e-6)
    jfn = getattr(jrope, f"apply_rope_{layout}")
    tfn = getattr(trope, f"apply_rope_{layout}")
    np.testing.assert_allclose(n(tfn(t(x), tc, ts)), n(jfn(jnp.asarray(x), jc, js)), atol=1e-6)


@pytest.mark.parametrize("mask_dims", [None, 3, 4])
def test_mha_matches_jax(mask_dims):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 6, 14, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    mask = None
    if mask_dims:
        mask = rng.random((2, 6, 9)) > 0.3
        mask[..., 0] = True
        if mask_dims == 4:
            mask = mask[:, None]
    want = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     None if mask is None else jnp.asarray(mask))
    got = tattn.mha(t(q), t(k), t(v), None if mask is None else t(mask))
    np.testing.assert_allclose(n(got), n(want), **TOL)


def _decode_case(b, kblk, s_max, cache_lens, seed, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kblk, 14, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, 2, d)).astype(np.float32)
    v = rng.standard_normal((b, s_max, 2, d)).astype(np.float32)
    return q, k, v, np.asarray(cache_lens, np.int32)


# GQA 14/2 (flagship head layout, small D), cache_len on the S-block edges of
# the Pallas kernel's 64-key blocks, and B=2 with per-row cache_len
DECODE_CASES = [
    (1, 1, 128, [63]),
    (1, 1, 128, [64]),
    (1, 4, 128, [60]),
    (1, 4, 256, [127]),
    (2, 1, 256, [0, 191]),
    (2, 4, 256, [64, 188]),
]


# the JAX references jitted: one compile per shape where the eager calls
# dispatched (and the interpreted kernel compiled) op by op
_JAX_DECODE = jax.jit(jattn.decode_attention)
_JAX_PALLAS = jax.jit(lambda q, k, v, cl: pallas_decode_attention(q, k, v, cl, s_blk=64,
                                                                  interpret=True))


@pytest.mark.parametrize("b,kblk,s_max,cache_lens", DECODE_CASES)
def test_decode_attention_matches_jax_and_pallas(b, kblk, s_max, cache_lens):
    q, k, v, cl = _decode_case(b, kblk, s_max, cache_lens, seed=kblk * 100 + b)
    got = n(tattn.decode_attention(t(q), t(k), t(v), t(cl)))
    want = n(_JAX_DECODE(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl)))
    np.testing.assert_allclose(got, want, **TOL)
    for row in range(b):  # the TPU kernel is single-sequence
        pallas = _JAX_PALLAS(jnp.asarray(q[row]), jnp.asarray(k[row]), jnp.asarray(v[row]),
                             jnp.int32(cl[row]))
        np.testing.assert_allclose(got[row], n(pallas), **TOL)
    # the CPU dispatch takes the plain version
    np.testing.assert_array_equal(
        n(tattn.decode_attention_dispatch(t(q), t(k), t(v), t(cl))), got)


def test_decode_attention_full_block_mask_matches_jax():
    q, k, v, cl = _decode_case(2, 3, 64, [5, 40], seed=9)
    got = tattn.decode_attention(t(q), t(k), t(v), t(cl), block_causal=False)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(cl), block_causal=False)
    np.testing.assert_allclose(n(got), n(want), **TOL)
