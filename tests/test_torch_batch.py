"""The port's flash batch against the JAX package (tiny config, f32).

- `llm.generate_batched` token-exact (tokens, per-row counts, steps) under
  the JAX batched key chain replayed into the port, with the JAX side on its
  XLA attention and on its Pallas kernel in interpret mode;
- the batched RAS draw against the JAX vmap over rows;
- `flow.inference` with a per-row `prompt_mel_len` within 1e-3 (the
  BASELINE.md mel target);
- `Engine.synthesize_batch` against `Engine(fused=False).synthesize_batch`:
  per-row token counts and steps exact, each wav within WAV_LSB int16 steps
  (as tests/test_torch_engine.py holds `synthesize`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import flow as jflow
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.ops import sampling as js
from flowmirror_hydravox_tpu.ops.attention import set_pallas_decode
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch.models import flow as tflow
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.ops import sampling as ts
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from tests.torch_port_util import JaxReplayNoise, jit_o0, n, seeded_tiny_trees, t

CFG = tiny_config()
MAX_TOKENS = 48
WAV_LSB = 2 / 32767.0
RAS = dict(top_p=0.9, top_k=10, win_size=24, tau_r=0.2)


@pytest.fixture(scope="module")
def llm_params():
    jp = seeded_tiny_trees()[0]  # sharper logits than the 0.02 init gives
    return jp, from_numpy_tree(jp, "cpu")


# one compile for the module's cases, not one per op (or per case)
_JAX_PROMPTS = jit_o0(jax.vmap(lambda p, tt, tl_: jl.build_inference_prompt(
    p, CFG.llm, tt, tl_, jnp.zeros((0,), jnp.int32), jnp.int32(0)), (None, 0, 0)))


def _prompts(jp):
    """Three rows of different text lengths, padded to one block."""
    lens = [12, 5, 16]
    text = np.stack([(np.arange(16, dtype=np.int32) * (7 + i)) % 256 for i in range(3)])
    emb, plen = _JAX_PROMPTS(jp, jnp.asarray(text), jnp.asarray(lens, jnp.int32))
    return np.asarray(emb), [int(x) for x in np.asarray(plen)]


# row 1 ignores EOS up to its max_len, so its budget cuts its last group short
MIN_LEN = [6, 7, 3]
MAX_LEN = [40, 7, 30]


@pytest.mark.parametrize("heads,jax_path", [(1, "xla"), (3, "xla"), (3, "pallas_interpret")])
def test_generate_batched_token_exact(llm_params, heads, jax_path):
    jp, tp = llm_params
    emb, plen = _prompts(jp)
    key = jax.random.PRNGKey(100 + heads)
    set_pallas_decode(jax_path == "pallas_interpret", interpret=True)
    try:
        # jitted, as the engine runs it: one compile instead of one per op
        # of its prologue (a new function each call: the decode path is
        # read when it traces)
        want = jit_o0(lambda p, *a: jl.generate_batched(
            p, CFG.llm, *a, js.SamplingParams.make(**RAS), inference_head_num=heads,
            max_tokens=MAX_TOKENS))(
            jp, key, jnp.asarray(emb), jnp.asarray(plen, jnp.int32),
            jnp.asarray(MIN_LEN, jnp.int32), jnp.asarray(MAX_LEN, jnp.int32))
        want_tokens, want_num = np.asarray(want.tokens), np.asarray(want.num_tokens)
    finally:
        set_pallas_decode(None)
    noise = JaxReplayNoise(key)
    got = tl.generate_batched(tp, CFG.llm, t(emb), plen, MIN_LEN, MAX_LEN,
                              ts.SamplingParams.make(**RAS), noise, inference_head_num=heads,
                              max_tokens=MAX_TOKENS)
    assert got.num_tokens == [int(x) for x in want_num]
    assert got.steps == int(want.steps) == noise.steps
    assert got.num_tokens[1] == MAX_LEN[1]  # cut by its budget
    assert len(set(got.num_tokens)) > 1  # rows finished at different steps
    for r, num in enumerate(got.num_tokens):
        assert num >= min(MIN_LEN[r], MAX_LEN[r])
        np.testing.assert_array_equal(n(got.tokens)[r, :num], want_tokens[r, :num])


def test_ras_sample_heads_batched_matches_jax_vmap():
    v, sts, k, b = 58, 50, 3, 4
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((b, k, v))).astype(np.float32)
    logits[1, :, sts:] += 5.0  # stop ids dominate unless masked (row 1 ignores EOS)
    hist = rng.integers(0, sts, (b, 40)).astype(np.int32)
    rep = int(np.argmax(logits[2, 0, :sts]))
    hist[2, 4:14] = rep  # row 2's window is full of its top candidate
    logits[2, :, rep] += 4.0
    num = np.asarray([0, 12, 14, 30], np.int32)
    min_len = np.asarray([0, 15, 0, 2], np.int32)
    jp = js.SamplingParams.make(top_p=0.8, top_k=10, win_size=10, tau_r=0.1)
    key = jax.random.PRNGKey(9)

    @jit_o0  # one compile for the reference and its draws, not one per op
    def reference(key, *args):
        want = jax.vmap(lambda r, lg, hs, nm, mn: js.ras_sample_heads(r, lg, hs, nm, jp, mn, sts))(
            jax.random.split(key, b), *args)
        # the per-row draws exactly as the vmapped ras_sample_heads takes them
        nuc, flat = [], []
        for row_key in jax.random.split(key, b):
            hk = jax.random.split(row_key, k)
            pairs = [jax.random.split(x) for x in hk]
            nuc.append([jax.random.gumbel(p[0], (min(64, v),), jnp.float32) for p in pairs])
            flat.append([jax.random.gumbel(p[1], (v,), jnp.float32) for p in pairs])
        return want, nuc, flat

    want, nuc, flat = reference(key, *map(jnp.asarray, (logits, hist, num, min_len)))
    want = np.asarray(want)
    got = n(ts.ras_sample_heads_batched(
        t(logits), t(hist), t(num), ts.SamplingParams.make(top_p=0.8, top_k=10, win_size=10,
                                                          tau_r=0.1),
        t(min_len), sts, t(np.asarray(nuc)), t(np.asarray(flat))))
    np.testing.assert_array_equal(got, want)
    assert np.all(want[1] < sts)  # row 1's heads all ignored EOS
    assert np.any(want[2] != rep)  # row 2's repetition fallback drew elsewhere


@pytest.fixture(scope="module")
def flow_params():
    jp = seeded_tiny_trees()[1]
    return jp, from_numpy_tree(jp, "cpu")


def test_flow_inference_with_per_row_prompt_mel_len(flow_params):
    jp, tp = flow_params
    rng = np.random.default_rng(4)
    t_tok = 24
    token = rng.integers(0, CFG.flow.vocab_size, (2, t_tok)).astype(np.int32)
    valid = np.arange(t_tok)[None, :] < np.asarray([[20], [24]])
    emb = rng.standard_normal((2, 192)).astype(np.float32)
    pm_len = np.asarray([10, 4], np.int32)
    prompt = np.zeros((2, 16, 80), np.float32)
    for r, m in enumerate(pm_len):
        prompt[r, :m] = rng.standard_normal((m, 80))
    want = jit_o0(lambda p, *a: jflow.inference(p, CFG.flow, *a))(  # one compile, not one per op
        jp, jnp.asarray(token), jnp.asarray(valid), jnp.asarray(prompt), jnp.asarray(pm_len),
        jnp.asarray(emb))
    got = tflow.inference(tp, CFG.flow, t(token), t(valid), t(prompt), t(pm_len), t(emb))
    assert got.shape == (2, 80, t_tok * CFG.flow.token_mel_ratio)
    np.testing.assert_allclose(n(got), n(want), atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def engines():
    trees = seeded_tiny_trees()  # the JAX init of flow and HiFT takes tens of seconds
    jax_engine = JaxEngine(CFG, *trees, max_tokens=MAX_TOKENS, fused=False)
    torch_engine = TorchEngine(CFG, *(from_numpy_tree(tr, "cpu") for tr in trees),
                               max_tokens=MAX_TOKENS, device="cpu", fused=False)
    return jax_engine, torch_engine


TEXTS = [(np.arange(n_tok, dtype=np.int32) * (13 + i)) % 256 for i, n_tok in enumerate((10, 4, 7))]
BATCH_CASES = {
    # first: the JAX engine has executed no batch shape yet, so it takes the
    # ungrouped baseline dispatch (engine.py:855-877) that the port follows
    "b3_per_row_speakers": dict(
        text_tokens_list=TEXTS,
        spk_embedding=np.random.default_rng(1).standard_normal((3, 192)).astype(np.float32)),
    "b2_shared_prompt": dict(
        text_tokens_list=TEXTS[:2],
        prompt_speech_tokens=np.arange(6, dtype=np.int32) * 7 % 50,
        prompt_mel=np.random.default_rng(0).standard_normal((12, 80)).astype(np.float32),
        spk_embedding=np.random.default_rng(2).standard_normal(192).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_synthesize_batch_matches_jax_two_stage(engines, case):
    jax_engine, torch_engine = engines
    kwargs = dict(inference_head_num=2, **BATCH_CASES[case])
    if case == "b3_per_row_speakers":
        assert not jax_engine._warm_group_shapes  # read only: no planner groups
    key = jax.random.PRNGKey(len(case))
    want_wavs, want = jax_engine.synthesize_batch(rng=key, **kwargs)
    got_wavs, got = torch_engine.synthesize_batch(noise=JaxReplayNoise(key), **kwargs)
    assert "synth_groups" not in want
    assert got["tokens"] == want["tokens"] and got["steps"] == want["steps"]
    assert len(got_wavs) == len(want_wavs) == len(kwargs["text_tokens_list"])
    for g, w in zip(got_wavs, want_wavs):
        assert g.shape == w.shape and len(g) > 0 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=WAV_LSB, rtol=0)
