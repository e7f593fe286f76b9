"""Port RAS sampling against the JAX package.

`ras_dist` is deterministic: its support is held exactly and its values to
1e-6 (f32 softmax summation order). The draws are held token-exact with the
JAX Gumbel noise replayed into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.ops import sampling as js
from flowmirror_hydravox_tpu_torch.ops import sampling as ts
from tests.torch_port_util import jit_o0, n, t

V, STS = 58, 50  # tiny vocab: speech tokens 0..49, stop ids 50..57
JP = js.SamplingParams.make(top_p=0.8, top_k=10, win_size=10, tau_r=0.1)
TP = ts.SamplingParams.make(top_p=0.8, top_k=10, win_size=10, tau_r=0.1)


def _logits(seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (V,) if k is None else (k, V)
    return (2.0 * rng.standard_normal(shape)).astype(np.float32)


def _history(seed, num, repeat_of=None):
    rng = np.random.default_rng(seed)
    h = np.full((40,), -1, np.int32)
    h[:num] = rng.integers(0, STS, num)
    if repeat_of is not None:
        h[max(num - 10, 0):num] = repeat_of
    return h


# one compile for the cases, not one per op
_JAX_RAS_DIST = jit_o0(lambda lg, hist, num, eos: js.ras_dist(lg, hist, num, JP, eos, STS))


@pytest.mark.parametrize("seed,num,ignore_eos,repeat", [
    (0, 0, False, False), (1, 12, False, False), (2, 12, True, False), (3, 15, False, True),
    (4, 8, True, True)])
def test_ras_dist_matches_jax(seed, num, ignore_eos, repeat):
    logits = _logits(seed)
    top = int(np.argmax(logits[:STS]))
    hist = _history(seed, num, repeat_of=top if repeat else None)
    want = n(_JAX_RAS_DIST(jnp.asarray(logits), jnp.asarray(hist), jnp.int32(num),
                           jnp.bool_(ignore_eos)))
    got = n(ts.ras_dist(t(logits), t(hist), num, TP, ignore_eos, STS))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_top_k_ties_break_toward_lower_index():
    """The port's stable descending sort ranks ties as lax.top_k does."""
    probs = np.zeros((V,), np.float32)
    probs[[3, 9, 20, 21]] = 0.2
    probs[[1, 40]] = 0.1
    _, want = jax.lax.top_k(jnp.asarray(probs), min(64, V))
    _, got = ts._top_k(t(probs), min(64, V))
    np.testing.assert_array_equal(n(got), n(want))


def _jax_head_noise(key, k):
    """Per-head Gumbel draws exactly as ras_sample_heads takes them."""
    heads = jax.random.split(key, k)
    nuc, flat = [], []
    for hk in heads:
        rn, rf = jax.random.split(hk)
        nuc.append(np.asarray(jax.random.gumbel(rn, (min(64, V),), jnp.float32)))
        flat.append(np.asarray(jax.random.gumbel(rf, (V,), jnp.float32)))
    return t(np.stack(nuc)), t(np.stack(flat))


# the JAX sampler jitted, as the JAX decode loops run it: one compile where
# each eager call dispatched its ops one by one (~0.4 s a call)
_JAX_SAMPLE_HEADS = jit_o0(lambda key, logits, hist, num, min_len: js.ras_sample_heads(
    key, logits, hist, num, JP, min_len, STS))


@pytest.mark.parametrize("case", ["plain", "repetition_fallback", "ignore_eos"])
def test_ras_sample_heads_token_exact(case):
    k = 3
    hits = 0
    for trial in range(12):
        logits = _logits(100 + trial, k)
        num, min_len, rep = 14, 0, None
        if case == "repetition_fallback":
            rep = int(np.argmax(logits[0, :STS]))
            logits[:, rep] += 4.0  # every head's candidate is the repeated id
        if case == "ignore_eos":
            logits[:, STS:] += 5.0  # stop ids dominate unless masked
            min_len = num + 2  # heads 0, 1 ignore EOS, head 2 does not
        hist = _history(trial, num, repeat_of=rep)
        key = jax.random.PRNGKey(trial)
        want = np.asarray(_JAX_SAMPLE_HEADS(key, jnp.asarray(logits), jnp.asarray(hist),
                                            jnp.int32(num), jnp.int32(min_len)))
        nuc, flat = _jax_head_noise(key, k)
        got = n(ts.ras_sample_heads(t(logits), t(hist), num, TP, min_len, STS, nuc, flat))
        np.testing.assert_array_equal(got, want)
        if case == "repetition_fallback":
            hits += int(np.any(want != rep))  # the fallback drew elsewhere
        if case == "ignore_eos":
            assert np.all(want[:2] < STS)
            hits += int(want[2] >= STS)
    if case != "plain":
        assert hits > 0, "the case never exercised its branch"


def test_ras_sample_single_head_matches_jax():
    logits = _logits(7)
    hist = _history(7, 9)
    key = jax.random.PRNGKey(3)
    want = int(js.ras_sample(key, jnp.asarray(logits), jnp.asarray(hist), jnp.int32(9), JP,
                             jnp.bool_(False), STS))
    rn, rf = jax.random.split(key)
    got = int(ts.ras_sample(t(logits), t(hist), 9, TP, False, STS,
                            t(np.asarray(jax.random.gumbel(rn, (min(64, V),), jnp.float32))),
                            t(np.asarray(jax.random.gumbel(rf, (V,), jnp.float32)))))
    assert got == want


def test_sample_dist_matches_jax():
    dist = np.random.default_rng(5).dirichlet(np.ones(V)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = int(js.sample_dist(key, jnp.asarray(dist)))
    g = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
    assert int(ts.sample_dist(t(dist), t(g))) == want
    assert torch.is_tensor(ts.sample_dist(t(dist), t(g)))
