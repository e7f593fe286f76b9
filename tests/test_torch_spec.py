"""The port's self-speculative MTP decoding against the JAX package (tiny
config, head_num 3, so K = 2 and 3; f32; the port's seeded trees, CPU).

Every case draws the JAX key chain replayed into the port
(`JaxReplayNoise.spec_first` / `spec_step`, and the flash batch's split into
rows) unless it says otherwise; the JAX references are jitted.

- `generate_speculative`: tokens, num_tokens, steps, accepted and drafted
  exact, at K 2 and 3;
- greedy sampling (top_k 1, tau_r > 1): the port's spec tokens equal its
  heads=1 `generate`, on unrelated torch draws;
- `max_len` 0 commits nothing (llm.py:548-550);
- `generate_batched_speculative`: rows of different prompt lengths and
  budgets, one of them 0, under the solo case's checks;
- `generate_spec_until` paused at chunk targets equals the one-shot decode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.ops import sampling as js
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.noise import TorchNoise
from flowmirror_hydravox_tpu_torch.ops import sampling as ts
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import JaxReplayNoise, jit_o0, n, seeded_tiny_trees, t

CFG = tiny_config()
MAX_TOKENS = 40
RAS = dict(top_p=0.9, top_k=10, win_size=24, tau_r=0.2)


@pytest.fixture(scope="module")
def llm_params():
    jp = seeded_tiny_trees()[0]
    return jp, from_numpy_tree(jp, "cpu")


def _jax_prompt_fn(jp, text, n_text):
    return jl.build_inference_prompt(jp, CFG.llm, text, n_text, jnp.zeros((0,), jnp.int32),
                                     jnp.int32(0))


_jax_prompt = jit_o0(_jax_prompt_fn)  # one compile per text length, not one per op


def _prompt(jp, text):
    emb, plen = _jax_prompt(jp, jnp.asarray(text), jnp.int32(len(text)))
    return np.asarray(emb), int(plen)


@functools.partial(jax.jit, static_argnums=(6,))
def _jax_spec(jp, key, emb, plen, min_len, max_len, heads):
    res = jl.generate_speculative(jp, CFG.llm, key, emb, plen, min_len, max_len,
                                  js.SamplingParams.make(**RAS), num_heads=heads,
                                  max_tokens=MAX_TOKENS)
    return res.result.tokens, res.result.num_tokens, res.result.steps, res.accepted, res.drafted


def _check(got: tl.SpecResult, want, row=None):
    tokens, num, steps, accepted, drafted = (np.asarray(w) for w in want)
    got_num = got.result.num_tokens if row is None else got.result.num_tokens[row]
    want_num = int(num if row is None else num[row])
    got_tokens = n(got.result.tokens if row is None else got.result.tokens[row])
    assert got_num == want_num
    np.testing.assert_array_equal(got_tokens[:got_num],
                                  (tokens if row is None else tokens[row])[:want_num])
    assert (got.result.steps, got.accepted, got.drafted) == (int(steps), int(accepted),
                                                             int(drafted))


@pytest.mark.parametrize("heads", [2, 3])
def test_generate_speculative_matches_jax(llm_params, heads):
    jp, tp = llm_params
    emb, plen = _prompt(jp, (np.arange(7, dtype=np.int32) * 13) % 256)
    key = jax.random.PRNGKey(40 + heads)
    want = _jax_spec(jp, key, jnp.asarray(emb), jnp.int32(plen), jnp.int32(20), jnp.int32(34),
                     heads)
    noise = JaxReplayNoise(key)
    got = tl.generate_speculative(tp, CFG.llm, t(emb), plen, 20, 34,
                                  ts.SamplingParams.make(**RAS), noise, num_heads=heads,
                                  max_tokens=MAX_TOKENS)
    _check(got, want)
    assert got.result.num_tokens >= 20 and noise.steps == got.result.steps
    assert got.drafted == (heads - 1) * got.result.steps and 0 < got.accepted < got.drafted


def test_greedy_spec_equals_heads1(llm_params):
    """Deterministic sampling: spec at K 3 emits heads=1's tokens whatever
    its draws (JAX tests/test_llm.py:189), in no more block forwards."""
    _, tp = llm_params
    jp = seeded_tiny_trees()[0]
    emb, plen = _prompt(jp, (np.arange(6, dtype=np.int32) * 5 + 1) % 256)
    greedy = ts.SamplingParams.make(top_p=0.5, top_k=1, win_size=10, tau_r=2.0)
    base = tl.generate(tp, CFG.llm, t(emb), plen, 4, 36, greedy,
                       TorchNoise(torch.Generator().manual_seed(1)), inference_head_num=1,
                       max_tokens=MAX_TOKENS)
    spec = tl.generate_speculative(tp, CFG.llm, t(emb), plen, 4, 36, greedy,
                                   TorchNoise(torch.Generator().manual_seed(2)), num_heads=3,
                                   max_tokens=MAX_TOKENS)
    assert spec.result.num_tokens == base.num_tokens >= 4
    np.testing.assert_array_equal(n(spec.result.tokens)[:base.num_tokens],
                                  n(base.tokens)[:base.num_tokens])
    assert spec.result.steps <= base.steps and spec.drafted == 2 * spec.result.steps


def test_max_len_zero_commits_nothing(llm_params):
    jp, tp = llm_params
    emb, plen = _prompt(jp, np.arange(5, dtype=np.int32))
    noise = JaxReplayNoise(jax.random.PRNGKey(3))
    got = tl.generate_speculative(tp, CFG.llm, t(emb), plen, 0, 0,
                                  ts.SamplingParams.make(**RAS), noise, num_heads=3,
                                  max_tokens=MAX_TOKENS)
    assert (got.result.num_tokens, got.result.steps, got.accepted, got.drafted) == (0, 0, 0, 0)
    assert (n(got.result.tokens) == -1).all() and noise.steps == 0


@functools.partial(jax.jit, static_argnums=(6,))
def _jax_batched_spec(jp, key, emb, plen, min_len, max_len, heads):
    res = jl.generate_batched_speculative(jp, CFG.llm, key, emb, plen, min_len, max_len,
                                          js.SamplingParams.make(**RAS), num_heads=heads,
                                          max_tokens=MAX_TOKENS)
    return res.result.tokens, res.result.num_tokens, res.result.steps, res.accepted, res.drafted


def test_generate_batched_speculative_matches_jax(llm_params):
    """Four rows: text lengths 12, 5, 16, 9 padded to one block; row 1
    ignores EOS up to its budget, row 3's budget is 0."""
    jp, tp = llm_params
    lens = [12, 5, 16, 9]
    text = np.stack([(np.arange(16, dtype=np.int32) * (7 + i)) % 256 for i in range(4)])
    emb, plen = jit_o0(jax.vmap(_jax_prompt_fn, (None, 0, 0)))(  # one compile
        jp, jnp.asarray(text), jnp.asarray(lens, jnp.int32))
    min_len, max_len = [6, 7, 3, 0], [34, 7, 25, 0]
    key = jax.random.PRNGKey(77)
    want = _jax_batched_spec(jp, key, emb, plen, jnp.asarray(min_len, jnp.int32),
                             jnp.asarray(max_len, jnp.int32), 3)
    noise = JaxReplayNoise(key)
    got = tl.generate_batched_speculative(
        tp, CFG.llm, t(np.asarray(emb)), [int(x) for x in np.asarray(plen)], min_len, max_len,
        ts.SamplingParams.make(**RAS), noise, num_heads=3, max_tokens=MAX_TOKENS)
    assert got.result.num_tokens == [int(x) for x in np.asarray(want[1])]
    for r in range(4):
        _check(got, want, row=r)
    assert got.result.num_tokens[1] == 7 and got.result.num_tokens[3] == 0
    assert len(set(got.result.num_tokens)) == 4 and noise.steps == got.result.steps


def test_spec_until_chunks_equal_oneshot(llm_params):
    """A stream's decode: paused at each chunk target, the same draws give
    the one-shot tokens (JAX tests/test_streaming.py:97)."""
    jp, tp = llm_params
    emb, plen = _prompt(jp, np.arange(6, dtype=np.int32))
    key = jax.random.PRNGKey(13)
    sp = ts.SamplingParams.make(**RAS)
    oneshot = tl.generate_speculative(tp, CFG.llm, t(emb), plen, 4, 30, sp, JaxReplayNoise(key),
                                      num_heads=3, max_tokens=MAX_TOKENS)
    noise = JaxReplayNoise(key)
    state = tl.init_spec_state(tp, CFG.llm, t(emb), plen, 4, 30, sp, noise, num_heads=3,
                               max_tokens=MAX_TOKENS)
    nums = []
    for target in (7, 14, 21, 30):
        state = tl.generate_spec_until(tp, CFG.llm, state, target, sp, noise, num_heads=3)
        nums.append(state["num"][0])
        if state["finished"][0]:
            break
    assert len(nums) > 1 and nums[0] >= 7
    assert state["num"][0] == oneshot.result.num_tokens
    np.testing.assert_array_equal(n(state["tokens"][0, :state["num"][0]]),
                                  n(oneshot.result.tokens[:oneshot.result.num_tokens]))
    assert (state["steps"], state["accepted"][0]) == (oneshot.result.steps, oneshot.accepted)
