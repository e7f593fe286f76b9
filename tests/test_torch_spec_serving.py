"""Speculative decoding on the port's serving routes against the JAX package
(tiny config, head_num 3; f32; the port's seeded trees, CPU), every route
on an engine with spec_decode:

- `Engine.synthesize` against the JAX `Engine(spec_decode=True)` (its
  default fused rule), on a text whose estimated stage-2 bucket is also its
  realised one, so the port's fused and two-stage rules both give JAX's
  wav: tokens, steps and `spec_acceptance` exact, wav within WAV_LSB int16
  steps;
- `Engine.synthesize_batch` (the flash batch) under the same checks;
- a stream on the lane (`synthesize_stream`): tokens and acceptance those
  of the JAX spec decode of the stream's decode key (JAX
  tests/test_streaming.py:97);
- the spec slots: tokens and acceptance those of the JAX
  `generate_speculative` of each request's key, one request admitted
  while the other decodes (JAX tests/test_continuous.py:424, :448), and a
  stream riding them (:475);
- the launcher's `--spec-decode` and a `TTSService` on 2 spec slots at
  heads 2, whose requests ride the slots (:496); slots at one head are
  refused (server.py:107-112)."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.ops import sampling as js
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.noise import StreamNoise
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.continuous import ContinuousBatcher
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from flowmirror_hydravox_tpu_torch.runtime.server import TTSService
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

CFG = tiny_config()
MAX_TOKENS = 48
WAV_LSB = 2 / 32767.0
TIMEOUT = 120.0
HEADS = 3


def _text(n, mul):
    return (np.arange(n, dtype=np.int32) * mul + 1) % 256


@pytest.fixture(scope="module")
def engines():
    """(the JAX engine, {fused: the port's engine}), all with spec_decode."""
    trees = seeded_tiny_trees()
    port_trees = [from_numpy_tree(tr, "cpu") for tr in trees]
    return (JaxEngine(CFG, *trees, max_tokens=MAX_TOKENS, spec_decode=True),
            {fused: TorchEngine(CFG, *port_trees, max_tokens=MAX_TOKENS, device="cpu",
                                fused=fused, spec_decode=True)
             for fused in (True, False)})


# 17 text tokens: min_len 34, so the realised bucket is 64, the estimate's
SOLO = dict(text_tokens=_text(17, 13), tts_text_len=17, inference_head_num=HEADS)


@pytest.fixture(scope="module")
def jax_solo(engines):
    return engines[0].synthesize(rng=jax.random.PRNGKey(5), **SOLO)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_stage"])
def test_synthesize_matches_jax(engines, jax_solo, fused):
    want = jax_solo
    got = engines[1][fused].synthesize(noise=JaxReplayNoise(jax.random.PRNGKey(5)), **SOLO)
    assert (got.token_bucket, got.estimated) == (64, fused)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.steps == want.steps and len(got.speech_tokens) > got.steps
    assert got.spec_acceptance == want.spec_acceptance and 0 < got.spec_acceptance < 1
    assert got.audio.shape == want.audio.shape and len(got.audio) > 0
    np.testing.assert_allclose(got.audio, want.audio, atol=WAV_LSB, rtol=0)


def test_synthesize_batch_matches_jax(engines):
    jax_engine, torch_engine = engines[0], engines[1][True]
    kwargs = dict(text_tokens_list=[_text(10, 13), _text(4, 14), _text(7, 15)],
                  inference_head_num=HEADS,
                  spk_embedding=np.random.default_rng(1).standard_normal((3, 192)).astype(
                      np.float32))
    key = jax.random.PRNGKey(9)
    want_wavs, want = jax_engine.synthesize_batch(rng=key, **kwargs)
    got_wavs, got = torch_engine.synthesize_batch(noise=JaxReplayNoise(key), **kwargs)
    assert got["tokens"] == want["tokens"] and got["steps"] == want["steps"]
    assert got["spec_acceptance"] == want["spec_acceptance"]
    assert len(set(got["tokens"])) > 1
    for g, w in zip(got_wavs, want_wavs):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g, w, atol=WAV_LSB, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_spec_fn(cap, sampling):
    sampling = js.SamplingParams.make(*sampling)

    def fn(jp, key, text, n_text, min_len, max_len):
        emb, plen = jl.build_inference_prompt(jp, CFG.llm, text, n_text,
                                              jnp.zeros((0,), jnp.int32), jnp.int32(0))
        res = jl.generate_speculative(jp, CFG.llm, key, emb, plen, min_len, max_len, sampling,
                                      num_heads=HEADS, max_tokens=MAX_TOKENS, cache_len_cap=cap)
        return res.result.tokens, res.result.num_tokens, res.accepted, res.drafted

    return jax.jit(fn)


def _jax_spec(text, key, cap, sampling):
    """(tokens, accepted / drafted) of the JAX spec decode of `text` at the
    text bucket 32, cache cap `cap` and `sampling` (top_p, top_k, win_size,
    tau_r), with the port's default length bounds."""
    padded = np.zeros((32,), np.int32)
    padded[:len(text)] = text
    tokens, num, acc, drafted = _jax_spec_fn(cap, tuple(sampling))(
        seeded_tiny_trees()[0], key, jnp.asarray(padded), jnp.int32(len(text)),
        jnp.int32(2 * len(text)), jnp.int32(min(20 * len(text), MAX_TOKENS)))
    return np.asarray(tokens)[:int(num)].tolist(), int(acc) / max(int(drafted), 1)


def _stream_noise(key):
    decode_key, hift_key = jax.random.split(key)
    return decode_key, StreamNoise(JaxReplayNoise(decode_key), JaxReplayNoise(hift_key))


def test_lane_spec_stream_matches_jax(engines):
    torch_engine = engines[1][True]
    text = _text(15, 7)
    decode_key, noise = _stream_noise(jax.random.PRNGKey(33))
    session = {}
    chunks = list(torch_engine.streaming().synthesize_stream(
        text, len(text), inference_head_num=HEADS, noise=noise, session=session))
    sp = CFG.tts_sampling  # the engine's default
    tokens, acceptance = _jax_spec(text, decode_key, 2 + 32 + MAX_TOKENS + HEADS,
                                   (sp.top_p, sp.top_k, sp.win_size, sp.tau_r))
    assert session["tokens"] == tokens and len(tokens) > 28  # past the first chunk
    assert session["spec_acceptance"] == acceptance
    assert len(chunks) >= 2 and all(len(c) > 0 and np.isfinite(c).all() for c in chunks)


@contextlib.contextmanager
def _spec_batcher(engine):
    b = ContinuousBatcher(engine, slots=2, head_num=HEADS, spec_decode=True)
    try:
        yield b
    finally:
        b.shutdown()


def test_spec_slots_match_solo_with_mid_flight_admission(engines):
    """The first tick, driven by hand before the batcher's thread starts,
    admits request 1 and runs a chunk that cannot finish it (its min_len 28
    is past 8 steps of at most 3 tokens); request 2 then joins while it
    decodes."""
    torch_engine = engines[1][True]
    requests = [(_text(14, 5), 11), (_text(6, 9), 22)]
    with _spec_batcher(torch_engine) as b:
        b._started, b._state = True, b._init_state()  # the thread waits for the first tick
        r1 = b.submit(requests[0][0], noise=JaxReplayNoise(jax.random.PRNGKey(11)))
        b._tick()
        assert b._slot_req[0] is r1 and not b._state["finished"][0]
        r2 = b.submit(requests[1][0], noise=JaxReplayNoise(jax.random.PRNGKey(22)))
        b._thread.start()
        got = [b.result(r, timeout=TIMEOUT) for r in (r1, r2)]
        assert b.stats["admits"] == 2 and b.stats["forwards"] == b.stats["steps"]
    for (wav, stats), (text, key) in zip(got, requests):
        tokens, acceptance = _jax_spec(text, jax.random.PRNGKey(key), b.cache_cap, b.sampling)
        assert stats["tokens"] == tokens and stats["spec_acceptance"] == pytest.approx(acceptance)
        assert len(wav) == len(tokens) * 2 * 480 and np.isfinite(wav).all()


def test_stream_rides_spec_slots(engines):
    torch_engine = engines[1][True]
    text = _text(15, 7)
    decode_key, noise = _stream_noise(jax.random.PRNGKey(33))
    with _spec_batcher(torch_engine) as b:
        req = b.submit(text, noise=noise, stream=True)
        chunks = list(b.stream_result(req, timeout=TIMEOUT))
        assert b.stats["admits"] == 1  # no burst on spec slots
    tokens, acceptance = _jax_spec(text, decode_key, b.cache_cap, b.sampling)
    assert req.stats["tokens"] == tokens and len(tokens) > 28
    assert req.stats["spec_acceptance"] == pytest.approx(acceptance) and req.stats["ttft"] > 0
    assert len(chunks) >= 2 and all(len(c) > 0 and np.isfinite(c).all() for c in chunks)


def test_spec_service_rides_slots():
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", "32", "--spec-decode"]))
    assert engine.spec_decode
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=2,
                         continuous_head_num=2)
    try:
        assert service.batcher.spec and service.batcher.head_k == 2
        tids = [service.submit({"type": "tts", "text": text, "speaker_id": "default",
                                "extra_params": {}})
                for text in ("spec on slots", "The first part! And a second one.")]
        results = [service.wait(tid) for tid in tids]
        assert service.continuous_requests == 2 and service.batcher.stats["admits"] == 3
        for res in results:
            assert res["sample_rate"] == 24000 and len(res["output_audio"]) > 0, res
        with pytest.raises(ValueError, match="--continuous-heads >= 2"):
            TTSService(engine, frontend, continuous_slots=2, continuous_head_num=1)
    finally:
        service.shutdown()
