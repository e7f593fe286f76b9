"""Port MTP LM against the JAX package (tiny config, head_num=3, f32).

`generate` is held token-exact (tokens, num_tokens, steps) for heads 1..3:
under default RAS sampling with the JAX Gumbel noise replayed into the port,
with the JAX side on its XLA attention and on its Pallas kernel in interpret
mode, and under top_k=1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.ops.attention import set_pallas_decode
from flowmirror_hydravox_tpu.ops.sampling import SamplingParams as JSP
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.ops.sampling import SamplingParams as TSP
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import JaxReplayNoise, n, seeded_tiny_trees, t

CFG = tiny_config().llm
MAX_TOKENS = 48


@pytest.fixture(scope="module")
def params():
    jp = seeded_tiny_trees()[0]  # sharper logits than the 0.02 init gives
    return jp, from_numpy_tree(jp, "cpu")


def test_mtp_logits_match_jax(params):
    jp, tp = params
    h = np.random.default_rng(0).standard_normal((2, CFG.backbone.hidden_size)).astype(np.float32)
    want = jl.mtp_logits(jp, CFG, jnp.asarray(h), 3)
    got = tl.mtp_logits(tp, CFG, t(h), 3)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("lp", [0, 5])
def test_build_inference_prompt_matches_jax(params, lp):
    jp, tp = params
    text = np.arange(3, 19, dtype=np.int32)  # padded to 16, 11 real
    sp = (np.arange(8, dtype=np.int32) * 3) % 50
    want, wlen = jl.build_inference_prompt(jp, CFG, jnp.asarray(text), jnp.int32(11),
                                           jnp.asarray(sp[:lp]), jnp.int32(lp))
    got, glen = tl.build_inference_prompt(tp, CFG, t(text), 11, t(sp[:lp]), lp)
    np.testing.assert_array_equal(n(got), n(want))
    assert glen == int(wlen)


def _prompt(params):
    jp, tp = params
    text = (np.arange(16, dtype=np.int32) * 7) % 256
    emb, plen = jl.build_inference_prompt(jp, CFG, jnp.asarray(text), jnp.int32(12),
                                          jnp.zeros((0,), jnp.int32), jnp.int32(0))
    return np.asarray(emb), int(plen)


RAS = dict(top_p=0.9, top_k=10, win_size=24, tau_r=0.2)
GREEDY = dict(top_p=0.9, top_k=1, win_size=24, tau_r=2.0)  # top_k=1, no fallback
# JAX's generate jitted, as its engine runs it: one compile per head count
# where the eager call compiled its loop and each op around it. One jitted
# function per attention path: the path is read while tracing.
_JAX_GENERATE = {path: jax.jit(lambda p, *a, heads: jl.generate(
    p, CFG, *a, inference_head_num=heads, max_tokens=MAX_TOKENS), static_argnames="heads")
    for path in ("xla", "pallas_interpret")}


@pytest.mark.parametrize("heads,sampling,jax_path", [
    (1, "ras", "xla"), (2, "ras", "xla"), (3, "ras", "xla"),
    (1, "ras", "pallas_interpret"), (2, "ras", "pallas_interpret"), (3, "ras", "pallas_interpret"),
    (1, "top_k1", "xla"), (2, "top_k1", "xla"), (3, "top_k1", "xla"),
])
def test_generate_token_exact(params, heads, sampling, jax_path):
    jp, tp = params
    emb, plen = _prompt(params)
    sp = RAS if sampling == "ras" else GREEDY
    min_len, max_len = 6, 40
    key = jax.random.PRNGKey(heads * 10 + (sampling == "ras"))
    set_pallas_decode(jax_path == "pallas_interpret", interpret=True)
    try:
        want = _JAX_GENERATE[jax_path](jp, key, jnp.asarray(emb), jnp.int32(plen),
                                       jnp.int32(min_len), jnp.int32(max_len), JSP.make(**sp),
                                       heads=heads)
        want_tokens = np.asarray(want.tokens)
    finally:
        set_pallas_decode(None)
    noise = JaxReplayNoise(key)
    got = tl.generate(tp, CFG, t(emb), plen, min_len, max_len, TSP.make(**sp), noise,
                      inference_head_num=heads, max_tokens=MAX_TOKENS)
    assert got.num_tokens == int(want.num_tokens)
    assert got.steps == int(want.steps) == noise.steps
    np.testing.assert_array_equal(n(got.tokens)[:got.num_tokens], want_tokens[:got.num_tokens])
    assert got.num_tokens >= min(min_len, max_len)


def test_generate_stops_at_max_len_budget(params):
    """The budget cuts the last group short (n_accept = max_len - num)."""
    jp, tp = params
    emb, plen = _prompt(params)
    key = jax.random.PRNGKey(5)
    want = _JAX_GENERATE["xla"](jp, key, jnp.asarray(emb), jnp.int32(plen), jnp.int32(40),
                                jnp.int32(7), JSP.make(**RAS), heads=3)
    got = tl.generate(tp, CFG, t(emb), plen, 40, 7, TSP.make(**RAS), JaxReplayNoise(key),
                      inference_head_num=3, max_tokens=MAX_TOKENS)
    assert got.num_tokens == int(want.num_tokens) == 7
    np.testing.assert_array_equal(n(got.tokens)[:7], np.asarray(want.tokens)[:7])
