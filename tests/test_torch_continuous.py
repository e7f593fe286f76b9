"""The port's continuous batcher and its serving route against the JAX
package (tiny config, f32).

- Slot tokens exactly equal to the JAX `llm.generate` of the request's key at
  the JAX batcher's cache cap (the reference tests/test_continuous.py holds
  the JAX batcher to), the port's request drawing from a replay of that key;
  heads 1 and 3, and the JAX side on its Pallas kernel in interpret mode.
- The JAX `ContinuousBatcher` itself on the same keys: tokens exact, each wav
  within WAV_LSB int16 steps (this pins the TOKEN_BUCKETS synthesis).
- Mid-flight admission, more requests than slots, a freed slot at the cache's
  last block, a failed step, shutdown; `TTSService` routing, the metrics
  route and the launcher's flags."""

import contextlib
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.ops import sampling as js
from flowmirror_hydravox_tpu.ops.attention import set_pallas_decode
from flowmirror_hydravox_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.noise import TorchNoise
from flowmirror_hydravox_tpu_torch.ops import sampling as ts
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime import continuous
from flowmirror_hydravox_tpu_torch.runtime.continuous import ContinuousBatcher
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from flowmirror_hydravox_tpu_torch.runtime.server import TTSService, make_server
from tests.torch_port_util import JaxReplayNoise, jit_o0, seeded_tiny_trees

CFG = tiny_config()
MAX_TOKENS = 48
WAV_LSB = 2 / 32767.0
TIMEOUT = 120.0
# (text, key): two text lengths; each decode stops by MAX_TOKENS
REQUESTS = [(np.arange(6, dtype=np.int32) * 11 % 256, 11),
            ((np.arange(9, dtype=np.int32) * 5 + 3) % 256, 22)]


@pytest.fixture(scope="module")
def engines():
    """The JAX engine (default bucket ladders, so both batchers have the
    same cache cap) and the port's, on the same f32 weights: the port's
    seeded init (the JAX init of HiFT and flow takes half a minute on the
    CPU), in the JAX package's layout."""
    trees = seeded_tiny_trees()  # sharper logits than the 0.02 init gives
    jax_engine = JaxEngine(CFG, *trees, max_tokens=MAX_TOKENS, fused=False)
    torch_engine = TorchEngine(CFG, *(from_numpy_tree(tr, "cpu") for tr in trees),
                               max_tokens=MAX_TOKENS, device="cpu")
    return jax_engine, torch_engine


def _jax_solo_decode(jax_engine, heads):
    """JAX `llm.generate` of one request at the JAX batcher's cache cap and
    text bucket (tests/test_continuous.py::_solo_tokens), jitted as the
    engine runs it: one compile for the requests of one call, instead of one
    per op of its prologue. `fn(text, key) -> tokens`; a new program for each
    call, since the decode path is read when it traces."""
    cap = JaxBatcher(jax_engine, slots=1, head_num=heads).cache_cap

    @jit_o0
    def run(jp, padded, n_text, key, min_len, max_len):
        emb, plen = jl.build_inference_prompt(jp, CFG.llm, padded, n_text,
                                              jnp.zeros((0,), jnp.int32), jnp.int32(0))
        res = jl.generate(jp, CFG.llm, key, emb, plen, min_len, max_len,
                          js.SamplingParams.make(), inference_head_num=heads,
                          max_tokens=MAX_TOKENS, cache_len_cap=cap)
        return res.tokens, res.num_tokens

    def fn(text, key):
        padded = np.zeros((32,), np.int32)
        padded[:len(text)] = text
        tokens, num = run(jax_engine.llm_params, jnp.asarray(padded), jnp.int32(len(text)),
                          jax.random.PRNGKey(key), jnp.int32(2 * len(text)),
                          jnp.int32(min(20 * len(text), MAX_TOKENS)))
        return np.asarray(tokens)[:int(num)].tolist()

    return fn


@contextlib.contextmanager
def _batcher(engine, **kwargs):
    b = ContinuousBatcher(engine, **kwargs)
    try:
        yield b
    finally:
        b.shutdown()


@pytest.mark.parametrize("heads,jax_path", [(1, "xla"), (3, "xla"), (3, "pallas_interpret")])
def test_slot_tokens_match_jax_solo_decode(engines, heads, jax_path):
    jax_engine, torch_engine = engines
    with _batcher(torch_engine, slots=2, head_num=heads) as b:
        assert b.cache_cap == JaxBatcher(jax_engine, slots=2, head_num=heads).cache_cap
        reqs = [b.submit(text, noise=JaxReplayNoise(jax.random.PRNGKey(key)))
                for text, key in REQUESTS]
        got = [b.result(r, timeout=TIMEOUT)[1]["tokens"] for r in reqs]
    set_pallas_decode(jax_path == "pallas_interpret", interpret=True)
    try:
        solo = _jax_solo_decode(jax_engine, heads)
        want = [solo(text, key) for text, key in REQUESTS]
    finally:
        set_pallas_decode(None)
    assert got == want
    assert all(len(w) > 0 for w in want)


def test_slots_match_the_jax_batcher(engines):
    """Tokens exact and wavs within WAV_LSB of the JAX ContinuousBatcher on
    the same keys (2 slots, heads 2)."""
    jax_engine, torch_engine = engines
    jb = JaxBatcher(jax_engine, slots=2, head_num=2)
    try:
        jreqs = [jb.submit(text, rng=jax.random.PRNGKey(key)) for text, key in REQUESTS]
        want = [jb.result(r, timeout=600.0) for r in jreqs]
    finally:
        jb.shutdown()
    with _batcher(torch_engine, slots=2, head_num=2) as b:
        reqs = [b.submit(text, noise=JaxReplayNoise(jax.random.PRNGKey(key)))
                for text, key in REQUESTS]
        got = [b.result(r, timeout=TIMEOUT) for r in reqs]
    for (g_wav, g_stats), (w_wav, w_stats) in zip(got, want):
        assert g_stats["tokens"] == w_stats["tokens"] and g_stats["steps"] == w_stats["steps"]
        assert g_wav.shape == w_wav.shape and len(g_wav) > 0 and np.isfinite(g_wav).all()
        np.testing.assert_allclose(g_wav, w_wav, atol=WAV_LSB, rtol=0)


def _port_solo_tokens(engine, text, seed, cap):
    """The port's solo decode (llm.generate, heads 2) of one request on a
    seeded torch noise source."""
    padded = np.zeros((32,), np.int32)
    padded[:len(text)] = text
    emb, plen = tl.build_inference_prompt(
        engine.llm_params, CFG.llm, torch.as_tensor(padded), len(text),
        torch.zeros((0,), dtype=torch.int32), 0)
    res = tl.generate(engine.llm_params, CFG.llm, emb, plen, 2 * len(text),
                      min(20 * len(text), MAX_TOKENS), ts.SamplingParams.make(),
                      _seeded(seed), inference_head_num=2, max_tokens=MAX_TOKENS,
                      cache_len_cap=cap)
    return res.tokens[:res.num_tokens].tolist()


def _seeded(seed):
    return TorchNoise(torch.Generator().manual_seed(seed))


def test_mid_flight_admission_and_more_requests_than_slots(engines):
    """A request submitted while another decodes joins the live batch; five
    requests on two slots all finish; each request's tokens equal its solo
    decode on the same noise."""
    _, engine = engines
    # the first decodes exactly MAX_TOKENS (its min_len is 2 x 24), so it
    # stays in flight for several chunks
    texts = [(np.arange(24 if i == 0 else 4 + 2 * i, dtype=np.int32) * (3 + i)) % 256
             for i in range(5)]
    with _batcher(engine, slots=2, head_num=2) as b:
        # the first is admitted and decodes one chunk on a tick driven here,
        # before the batcher's thread starts: the others then arrive while it
        # is in flight, whatever the host's speed
        b._started = True
        b._state = b._init_state()
        first = b.submit(texts[0], noise=_seeded(100))
        b._tick()
        assert first.t_admit is not None and first.t_decoded is None
        reqs = [first] + [b.submit(t, noise=_seeded(100 + i))
                          for i, t in enumerate(texts) if i > 0]
        b._thread.start()
        outs = [b.result(r, timeout=TIMEOUT) for r in reqs]
        assert b.stats["admits"] == 5 and len(b.admission_lat_s) == 5
        cap = b.cache_cap
    assert reqs[1].t_admit < reqs[0].t_decoded  # joined while the first decoded
    for i, (wav, stats) in enumerate(outs):
        assert stats["tokens"] == _port_solo_tokens(engine, texts[i], 100 + i, cap)
        assert len(wav) > 0 and np.isfinite(wav).all()


def test_freed_slot_at_the_last_block_decodes(engines):
    """A finished slot keeps its length and writes K uncommitted positions at
    every step; at length cap - K that write is the cache's last block, and
    the other slot decodes as it would alone."""
    _, engine = engines
    text = np.arange(7, dtype=np.int32)
    b = ContinuousBatcher(engine, slots=2, head_num=2)
    k, cap = b.head_k, b.cache_cap
    b._state = b._init_state()
    with torch.inference_mode():  # the state is made and updated in inference mode
        b._state["cache"].length[1] = cap - k
    b._started = True  # the thread starts by hand, after the state is set
    b._thread.start()
    try:
        req = b.submit(text, noise=_seeded(1))  # takes slot 0
        _, stats = b.result(req, timeout=TIMEOUT)
    finally:
        b.shutdown()
    cache = b._state["cache"]
    assert b.stats["admits"] == 1 and b.stats["forwards"] > 0
    assert int(cache.length[1]) == cap - k
    assert cache.k[:, 1, cap - k:].abs().sum() > 0  # the last block was written
    assert stats["tokens"] == _port_solo_tokens(engine, text, 1, cap)


def test_failed_step_fails_the_slots_then_serves(engines, monkeypatch):
    """A step that raises fails every in-slot request with its error; the
    state is rebuilt and the next request is served."""
    _, engine = engines
    step = tl.decode_step_batched
    broken = [True]

    def flaky(*args, **kwargs):
        if broken[0]:
            raise RuntimeError("injected step failure")
        return step(*args, **kwargs)

    monkeypatch.setattr(continuous.llm_model, "decode_step_batched", flaky)
    with _batcher(engine, slots=2, head_num=2) as b:
        reqs = [b.submit(np.arange(5, dtype=np.int32), noise=_seeded(i)) for i in range(2)]
        for r in reqs:
            with pytest.raises(RuntimeError, match="injected step failure"):
                b.result(r, timeout=TIMEOUT)
        broken[0] = False
        wav, stats = b.result(b.submit(np.arange(5, dtype=np.int32), noise=_seeded(3)),
                              timeout=TIMEOUT)
    assert len(wav) > 0 and len(stats["tokens"]) > 0


def test_shutdown_unblocks_waiters(engines):
    """Requests in slots, in the backlog and still pending all fail with
    'batcher shut down', and a waiter returns at once."""
    _, engine = engines
    b = ContinuousBatcher(engine, slots=2, head_num=2)
    b._started = True  # the loop thread never starts; ticks are driven by hand
    b._state = b._init_state()
    # each decodes exactly MAX_TOKENS (min_len 2 x 24), more than one chunk
    reqs = [b.submit(np.arange(24, dtype=np.int32), noise=_seeded(i)) for i in range(3)]
    b._tick()  # two take the slots, one waits in the backlog
    assert b._slot_req[0] is reqs[0] and b._slot_req[1] is reqs[1] and b._backlog == [reqs[2]]
    late = b.submit(np.arange(6, dtype=np.int32), noise=_seeded(9))  # still pending
    errors = []
    waiter = threading.Thread(target=lambda: errors.append(
        pytest.raises(RuntimeError, b.result, reqs[0], 60.0)))
    waiter.start()
    b._started = False  # no thread to join
    t0 = time.time()
    b.shutdown()
    waiter.join(timeout=10)
    assert not waiter.is_alive() and time.time() - t0 < 10
    assert "shut down" in str(errors[0].value)
    assert all(r.done.is_set() and r.error == "batcher shut down" for r in reqs + [late])
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(np.arange(3, dtype=np.int32))


@pytest.fixture(scope="module")
def tiny():
    return launcher.build(launcher.parse_args(["--tiny", "--device", "cpu",
                                               "--max-tokens", "32"]))


@contextlib.contextmanager
def _service(tiny, monkeypatch):
    """A continuous TTSService (2 slots, heads 2) on the tiny engine, whose
    worker-path engine calls are recorded."""
    engine, frontend = tiny
    calls = []
    synthesize, synthesize_batch = engine.synthesize, engine.synthesize_batch
    monkeypatch.setattr(engine, "synthesize",
                        lambda **kw: calls.append("synthesize") or synthesize(**kw))
    monkeypatch.setattr(engine, "synthesize_batch",
                        lambda rows, **kw: calls.append("synthesize_batch")
                        or synthesize_batch(rows, **kw))
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=2,
                         continuous_head_num=2)
    try:
        yield service, calls
    finally:
        service.shutdown()


def _task(text, **extra):
    return {"type": "tts", "text": text, "speaker_id": "default",
            "extra_params": extra}


LONG_TEXT = " ".join(f"word{i}" for i in range(80))  # one segment past 128 tokens
TWO_SEGMENTS = "The first sentence is here! And a second one follows."


def test_service_routes(tiny, monkeypatch):
    """Default requests ride the slots, one slot request per segment; a
    non-default request and a text past the slots' ladder take the worker."""
    _, frontend = tiny
    assert len(frontend.extract_text_tokens(LONG_TEXT)) > 128
    with _service(tiny, monkeypatch) as (service, calls):
        assert service.default_extra["inference_head_num"] == 2
        tids = [service.submit(_task(t)) for t in ("hello there world", TWO_SEGMENTS)]
        results = [service.wait(tid) for tid in tids]
        assert service.continuous_requests == 2 and calls == []
        assert service.batcher.stats["admits"] == 3  # 1 + 2 segments
        worker = [service.submit(_task("a custom request", top_p=0.5, inference_head_num=1)),
                  service.submit(_task(LONG_TEXT))]
        results += [service.wait(tid) for tid in worker]
        assert service.continuous_requests == 2
        assert calls == ["synthesize", "synthesize"]
        assert service.batcher.stats["admits"] == 3
    for res in results:
        assert res["sample_rate"] == 24000 and len(res["output_audio"]) > 0, res
        assert np.isfinite(res["output_audio"]).all()
    # two segments joined by a pause
    assert len(results[1]["output_audio"]) > 0.05 * 24000


def test_metrics_route(tiny):
    engine, frontend = tiny
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=TIMEOUT,
                         continuous_slots=2, continuous_head_num=2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.load(r)

    try:
        for extra in ({}, {"top_p": 0.5}):  # a slot request, then a worker request
            code, body = call("/api/v1/tts", {"text": "metrics please", "speaker_id": "default",
                                              "extra_params": extra})
            assert code == 200 and body["success"], body
        code, body = call("/api/v1/metrics")
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
    data = body["data"]
    assert code == 200 and body["success"]
    assert data["continuous_requests"] == 1 and data["batched_requests"] == 0
    assert data["requests"] == 1 and data["latency_p50_ms"] > 0  # the worker's synthesize
    for key in ("admission_ms_p50", "admission_ms_p95", "queue_wait_ms_p50",
                "queue_wait_ms_p95"):
        assert data[key] >= 0, key


@pytest.mark.parametrize("argv,slots", [([], 4), (["--continuous-batching", "0"], 0),
                                        (["--continuous-batching", "3",
                                          "--continuous-reserve", "2", "--with-ui"], 3)])
def test_launcher_batching_flags(monkeypatch, tiny, argv, slots):
    """The batching flags reach the service: the slots, their head count and
    the slots reserved for streams (default 1, as in the JAX launcher); the
    launcher asks cuDNN for deterministic algorithms, hands the server one
    TrainingManager on its --device and --tiny, and `with_ui` as
    --with-ui sets it."""
    reserve = 2 if "--continuous-reserve" in argv else 1
    seen = {}
    monkeypatch.setattr(launcher, "build", lambda args: tiny)
    monkeypatch.setattr(launcher, "serve", lambda *a, **kw: seen.update(kw))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    launcher.main(["--tiny", "--device", "cpu"] + argv)
    training = seen.pop("training")
    assert (type(training).__name__, training.device, training.tiny) == (
        "TrainingManager", "cpu", True)
    assert seen == {"continuous_slots": slots, "continuous_head_num": 2,
                    "continuous_reserve_stream": reserve, "with_ui": "--with-ui" in argv}
    assert torch.backends.cudnn.deterministic
    engine, frontend = tiny
    service = TTSService(engine, frontend, continuous_slots=slots,
                         continuous_reserve_stream=reserve)
    try:
        assert (service.batcher is None) == (slots == 0)
        assert slots == 0 or service.batcher.reserve_stream_slots == reserve
    finally:
        service.shutdown()
