"""The solo route's output rule: the port's `Engine.synthesize` against the
JAX engine's default `Engine(fused=True)` (engine.py:1121-1170) on the same
key (tiny config, f32, the port's seeded trees, CPU).

JAX runs flow + HiFT at a token bucket estimated from the text length
(`_estimate_token_bucket`) and keeps that wav when the realised tokens fit
it, else re-synthesises at the realised bucket. HiFT is non-causal over the
edge-replicated padding, so the bucket shows in the wav even with equal
tokens. Two requests: one whose estimate (64) holds although the realised
bucket would be 32, and one that outgrows its estimate (32) and falls back
(64). Tokens exact, the bucket JAX synthesised at (read from the programs it
built for the call: the fused one carries the estimate, a fallback builds a
stage-2 program at the realised bucket) equal to the port's, wav within
WAV_LSB int16 steps. At this size the two buckets' wavs differ by about
one int16 step (the flow's sums over other lengths), inside WAV_LSB: the
bucket check is what tells the rules apart here."""

import jax
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.engine import SYNTH_BUCKETS, _bucket
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

WAV_LSB = 2 / 32767.0
MAX_TOKENS = 64


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_config()
    trees = seeded_tiny_trees()
    return (JaxEngine(cfg, *trees, max_tokens=MAX_TOKENS),
            TorchEngine(cfg, *(from_numpy_tree(tr, "cpu") for tr in trees),
                        max_tokens=MAX_TOKENS, device="cpu"))


# (text length, key, estimated bucket, whether it holds)
CASES = {"estimate_holds": (10, 0, 64, True), "estimate_falls_back": (5, 5, 32, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_solo_route_matches_jax_fused(engines, case):
    jax_engine, torch_engine = engines
    n_text, seed, est_bucket, holds = CASES[case]
    kwargs = dict(text_tokens=(np.arange(n_text, dtype=np.int32) * 13) % 256,
                  tts_text_len=n_text, inference_head_num=2)
    key = jax.random.PRNGKey(seed)
    fused_before, synth_before = set(jax_engine._gen_cache), set(jax_engine._synth_cache)
    want = jax_engine.synthesize(rng=key, **kwargs)
    fused_keys = [k for k in set(jax_engine._gen_cache) - fused_before if k[0] == "fused"]
    synth_keys = list(set(jax_engine._synth_cache) - synth_before)
    got = torch_engine.synthesize(noise=JaxReplayNoise(key), **kwargs)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.steps == want.steps
    n_tok = len(got.speech_tokens)
    realised = _bucket(n_tok, SYNTH_BUCKETS)
    assert realised != est_bucket and [k[5] for k in fused_keys] == [est_bucket]
    jax_bucket = synth_keys[0][0] if synth_keys else est_bucket
    assert got.estimated == holds and got.token_bucket == jax_bucket
    assert jax_bucket == (est_bucket if holds else realised)
    assert got.audio.shape == want.audio.shape == (n_tok * 2 * 480,)
    np.testing.assert_allclose(got.audio, want.audio, atol=WAV_LSB, rtol=0)
