"""Port Engine.synthesize against the JAX two-stage engine
(`Engine(fused=False)`, the port's `fused=False` rule; the default fused
rule is held in tests/test_torch_solo_route.py) on the same key, tiny
config, f32 weights (the port's seeded init, shared with the other parity
tests).

The port replays the JAX key chain for both the LM draws and the HiFT source
(the JAX engine feeds one key to both). Tokens, token count and step count
must be exact; the int16 wav may differ by at most WAV_LSB quantisation
steps per sample (f32 summation order through flow and HiFT moves a few
samples across a rounding edge)."""

import jax
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

WAV_LSB = 2 / 32767.0
MAX_TOKENS = 64


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_config()
    trees = seeded_tiny_trees()  # the JAX init of flow and HiFT takes tens of seconds
    jax_engine = JaxEngine(cfg, *trees, max_tokens=MAX_TOKENS, fused=False)
    torch_engine = TorchEngine(cfg, *(from_numpy_tree(tr, "cpu") for tr in trees),
                               max_tokens=MAX_TOKENS, device="cpu", fused=False)
    return jax_engine, torch_engine


CASES = {
    "heads1": dict(inference_head_num=1),
    "heads2_prompted": dict(
        inference_head_num=2,
        prompt_speech_tokens=np.arange(6, dtype=np.int32) * 7 % 50,
        prompt_mel=np.random.default_rng(0).standard_normal((12, 80)).astype(np.float32),
        spk_embedding=np.random.default_rng(1).standard_normal(192).astype(np.float32)),
    "heads2_speed1.2": dict(inference_head_num=2, speed=1.2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_synthesize_matches_jax_two_stage(engines, case):
    jax_engine, torch_engine = engines
    kwargs = dict(text_tokens=(np.arange(10, dtype=np.int32) * 13) % 256, tts_text_len=10,
                  **CASES[case])
    key = jax.random.PRNGKey(len(case))
    want = jax_engine.synthesize(rng=key, **kwargs)
    got = torch_engine.synthesize(noise=JaxReplayNoise(key), **kwargs)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.steps == want.steps
    assert got.audio.shape == want.audio.shape and len(got.audio) > 0
    assert np.isfinite(got.audio).all()
    np.testing.assert_allclose(got.audio, want.audio, atol=WAV_LSB, rtol=0)
