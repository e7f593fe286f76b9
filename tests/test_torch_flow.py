"""Port DiT and flow-matching decoder against the JAX package (tiny config, f32).

Tolerances: the DiT velocity to atol 1e-4; the mel of `flow.inference` to
atol 1e-3, the BASELINE.md fidelity target (10 Euler steps accumulate the
f32 summation-order differences of 2 x 10 DiT calls)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import dit as jdit
from flowmirror_hydravox_tpu.models import flow as jflow
from flowmirror_hydravox_tpu_torch.models import dit as tdit
from flowmirror_hydravox_tpu_torch.models import flow as tflow
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import n, seeded_tiny_trees, t

CFG = tiny_config().flow


@pytest.fixture(scope="module")
def params():
    jp = seeded_tiny_trees()[1]  # the JAX init of the flow takes seconds
    return jp, from_numpy_tree(jp, "cpu")


def test_dit_forward_matches_jax(params):
    jp, tp = params
    ecfg = CFG.estimator
    rng = np.random.default_rng(0)
    b, tt = 2, 40
    x = rng.standard_normal((b, 80, tt)).astype(np.float32)
    mu = rng.standard_normal((b, ecfg.mu_dim, tt)).astype(np.float32)
    cond = rng.standard_normal((b, 80, tt)).astype(np.float32)
    spks = rng.standard_normal((b, ecfg.spk_dim)).astype(np.float32)
    tt_ = np.array([0.1, 0.7], np.float32)
    mask = np.ones((b, 1, tt), np.float32)
    mask[1, :, 31:] = 0  # padded rows: fully masked, uniform softmax
    want = jax.jit(lambda p, *a: jdit.forward(p, ecfg, *a))(  # one compile, not one per op
        jp["estimator"], *map(jnp.asarray, (x, mask, mu, tt_, spks, cond)))
    got = tdit.forward(tp["estimator"], ecfg, *map(t, (x, mask, mu, tt_, spks, cond)))
    assert np.isfinite(n(got)).all()
    np.testing.assert_allclose(n(got), n(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_prompt", [False, True])
def test_flow_inference_mel_within_1e3(params, with_prompt):
    jp, tp = params
    rng = np.random.default_rng(1)
    t_tok, n_valid = 32, 27
    token = rng.integers(0, CFG.vocab_size, (1, t_tok)).astype(np.int32)
    valid = (np.arange(t_tok) < n_valid)[None]
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    if with_prompt:
        pm_len = 10
        prompt = np.zeros((1, 16, 80), np.float32)
        prompt[0, :pm_len] = rng.standard_normal((pm_len, 80))
    else:
        pm_len, prompt = 0, np.zeros((1, 0, 80), np.float32)
    want = jax.jit(lambda p, *a: jflow.inference(p, CFG, *a))(
        jp, jnp.asarray(token), jnp.asarray(valid), jnp.asarray(prompt), jnp.int32(pm_len),
        jnp.asarray(emb))
    got = tflow.inference(tp, CFG, t(token), t(valid), t(prompt), pm_len, t(emb))
    assert got.shape == (1, 80, t_tok * CFG.token_mel_ratio)
    np.testing.assert_allclose(n(got), n(want), atol=1e-3, rtol=0)


def test_encode_tokens_and_speaker_projection_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    token = rng.integers(-2, CFG.vocab_size + 3, (2, 12)).astype(np.int32)  # clipped ids
    valid = rng.random((2, 12)) > 0.2
    np.testing.assert_allclose(
        n(tflow.encode_tokens(tp, CFG, t(token), t(valid))),
        n(jflow.encode_tokens(jp, CFG, jnp.asarray(token), jnp.asarray(valid))), atol=1e-5)
    emb = rng.standard_normal((2, 192)).astype(np.float32)
    np.testing.assert_allclose(n(tflow.project_speaker(tp, t(emb))),
                               n(jflow.project_speaker(jp, jnp.asarray(emb))), atol=1e-6)
