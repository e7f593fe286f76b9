"""Port Qwen2 backbone against the JAX package: hidden states and KV-cache
contents after a prefill with advance < T and after two decode blocks.

Tolerance: f32, atol 2e-5 / rtol 2e-4 (matmul summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import qwen2 as jq
from flowmirror_hydravox_tpu.ops.attention import set_pallas_decode
from flowmirror_hydravox_tpu_torch.models import qwen2 as tq
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import jit_o0, n, t, to_numpy_tree

TOL = dict(atol=2e-5, rtol=2e-4)
CFG = tiny_config().llm.backbone


@pytest.fixture(scope="module")
def params():
    p = to_numpy_tree(jq.init_params(jax.random.PRNGKey(0), CFG, jnp.float32))
    # non-trivial norms and biases so every term is exercised
    rng = np.random.default_rng(0)
    for name in ("input_layernorm", "post_attention_layernorm", "q_proj_b", "k_proj_b", "v_proj_b"):
        p["layers"][name] = p["layers"][name] + 0.1 * rng.standard_normal(
            p["layers"][name].shape).astype(np.float32)
    return p


def test_embed_and_rms_norm_match_jax(params):
    ids = np.array([[0, 5, 255, 300, -3]], np.int32)  # clipped ids included
    np.testing.assert_array_equal(n(tq.embed_tokens(from_numpy_tree(params, "cpu"), t(ids))),
                                  n(jq.embed_tokens(params, jnp.asarray(ids))))
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    w = params["layers"]["input_layernorm"][0]
    np.testing.assert_allclose(n(tq._rms_norm(t(x), t(w), 1e-6)),
                               n(jq._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), atol=1e-6)


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_prefill_and_decode_blocks_match_jax(params, jax_path):
    rng = np.random.default_rng(2)
    s_max, t_prompt, prompt_len, kblk = 256, 12, 9, 3
    blocks = [rng.standard_normal((1, t_prompt, CFG.hidden_size)).astype(np.float32)]
    blocks += [rng.standard_normal((1, kblk, CFG.hidden_size)).astype(np.float32) for _ in range(2)]
    advances = [prompt_len, kblk, 2]  # the prefill and the last block commit fewer than T

    tparams = from_numpy_tree(params, "cpu")
    tcache = tq.init_kv_cache(CFG, 1, s_max, dtype=torch.float32, device="cpu")
    jcache = jq.init_kv_cache(CFG, 1, s_max, dtype=jnp.float32)
    set_pallas_decode(jax_path == "pallas_interpret", interpret=True)
    try:
        # jitted: one compile per block shape, not one per op; a new program
        # for each path, since the decode path is read when it traces
        block = jit_o0(lambda p, x, c, adv: jq.forward_block_with_cache(p, CFG, x, c,
                                                                         advance=adv))
        for x, adv in zip(blocks, advances):
            jh, jcache = block(params, jnp.asarray(x), jcache, jnp.asarray([adv], jnp.int32))
            th, tcache = tq.forward_block_with_cache(
                tparams, CFG, t(x), tcache, advance=torch.tensor([adv], dtype=torch.int32))
            np.testing.assert_allclose(n(th), n(jh), **TOL)
            np.testing.assert_allclose(n(tcache.k), n(jcache.k), **TOL)
            np.testing.assert_allclose(n(tcache.v), n(jcache.v), **TOL)
            np.testing.assert_array_equal(n(tcache.length), n(jcache.length))
    finally:
        set_pallas_decode(None)
    assert int(tcache.length[0]) == prompt_len + kblk + 2


def test_batched_rows_with_different_lengths(params):
    """B=2 with per-row cache lengths: each row matches its own B=1 run."""
    rng = np.random.default_rng(3)
    tparams = from_numpy_tree(params, "cpu")
    x = rng.standard_normal((2, 4, CFG.hidden_size)).astype(np.float32)
    cache = tq.init_kv_cache(CFG, 2, 256, dtype=torch.float32, device="cpu")
    cache = cache._replace(length=torch.tensor([5, 17], dtype=torch.int32))
    got, _ = tq.forward_block_with_cache(tparams, CFG, t(x), cache)
    jcache = jq.init_kv_cache(CFG, 2, 256, dtype=jnp.float32)._replace(
        length=jnp.asarray([5, 17], jnp.int32))
    want, _ = jit_o0(lambda p, x, c: jq.forward_block_with_cache(p, CFG, x, c))(  # one compile
        params, jnp.asarray(x), jcache)
    np.testing.assert_allclose(n(got), n(want), **TOL)
