"""POST /api/v1/tts/stream on the port's server (tiny config, random
weights, CPU): the JAX server's RIFF header bytes, its error codes, and the
routes of a stream: a default stream rides the continuous slots, any other
stream takes the stream lane (so it never waits behind /tts work in the
worker), a two-segment stream has its pause, and a seeded stream gives the
same PCM on both routes."""

import contextlib
import json
import queue
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from flowmirror_hydravox_tpu_torch import __main__ as launcher
import tests.torch_port_util  # noqa: F401  (one torch thread per test worker)
from flowmirror_hydravox_tpu_torch.runtime.server import TTSService, make_server

TIMEOUT = 300.0
TWO_SEGMENTS = "The first sentence is here! And a second one follows."
# the JAX server's header (server.py:1335-1339), spelled out
JAX_HEADER = (b"RIFF\xff\xff\xff\xffWAVEfmt \x10\x00\x00\x00\x01\x00\x01\x00"
              + struct.pack("<II", 24000, 48000) + b"\x02\x00\x10\x00data\xff\xff\xff\xff")
SAMPLES_PER_TOKEN = 2 * 480  # token_mel_ratio x HiFT upsampling


@pytest.fixture(scope="module")
def tiny():
    return launcher.build(launcher.parse_args(["--tiny", "--device", "cpu",
                                               "--max-tokens", "32"]))


@contextlib.contextmanager
def _server(tiny, **kwargs):
    engine, frontend = tiny
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=TIMEOUT, **kwargs)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", server.RequestHandlerClass.service
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _stream(url, body):
    """(status, headers, body bytes) of POST /api/v1/tts/stream."""
    req = urllib.request.Request(url + "/api/v1/tts/stream", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _pcm(data: bytes) -> np.ndarray:
    assert data[:44] == JAX_HEADER
    return np.frombuffer(data[44:], "<i2")


@pytest.mark.parametrize("slots", [0, 2], ids=["window", "continuous"])
def test_stream_is_a_live_wav(tiny, slots):
    """A one-sentence stream on the stream lane (window mode) and on the
    slots: JAX's header bytes, then s16le PCM of a whole number of tokens."""
    with _server(tiny, continuous_slots=slots) as (url, service):
        code, headers, data = _stream(url, {"text": "hello there world",
                                            "speaker_id": "default"})
        assert (service.continuous_requests == 1) == (slots > 0)
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    assert headers["X-Sample-Rate"] == "24000"
    pcm = _pcm(data)
    assert len(pcm) > 0 and len(pcm) % SAMPLES_PER_TOKEN == 0


def test_stream_errors(tiny):
    with _server(tiny) as (url, _):
        for body in ({"speaker_id": "default"}, {"text": "hi"}, {"text": "", "speaker_id": "x"}):
            code, _, data = _stream(url, body)
            assert code == 400 and not json.loads(data)["success"], body
        code, _, data = _stream(url, {"text": "hi", "speaker_id": "nobody"})
        body = json.loads(data)
        assert code == 500 and not body["success"] and "default" in body["error"]


def _run_stream(service, text, **extra):
    """Submit a stream task and read its queue to the end: (chunks, task)."""
    task = {"type": "tts_stream", "text": text, "speaker_id": "default",
            "extra_params": {**service.default_extra, **extra}, "chunk_queue": queue.Queue()}
    service.submit(task)
    chunks = []
    while True:
        item = task["chunk_queue"].get(timeout=TIMEOUT)
        if item is None:
            return chunks, task
        assert not isinstance(item, Exception), item
        chunks.append(np.frombuffer(item, "<i2"))


def test_non_default_stream_takes_the_lane_while_the_worker_is_busy(tiny, monkeypatch):
    """Window mode: a /tts request holds the worker; a stream at top_p 0.5
    is served to its end meanwhile, by the stream lane."""
    engine, frontend = tiny
    release, entered = threading.Event(), threading.Event()
    synthesize = engine.synthesize

    def held(**kwargs):
        entered.set()
        release.wait(TIMEOUT)
        return synthesize(**kwargs)

    monkeypatch.setattr(engine, "synthesize", held)
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, batch_window=0.0)
    try:
        tid = service.submit({"type": "tts", "text": "hold the worker", "speaker_id": "default",
                              "extra_params": {"inference_head_num": 2}})
        assert entered.wait(TIMEOUT)
        chunks, _ = _run_stream(service, "a stream meanwhile", top_p=0.5)
        assert not release.is_set() and sum(len(c) for c in chunks) > 0
        release.set()
        assert len(service.wait(tid)["output_audio"]) > 0
    finally:
        release.set()
        service.shutdown()


def test_default_stream_rides_the_slots(tiny):
    """With the slots on, a default stream is one slot request per segment
    (continuous_requests +1); a stream at other heads takes the lane."""
    engine, frontend = tiny
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=2)
    try:
        chunks, _ = _run_stream(service, "ride the slots")
        assert service.continuous_requests == 1 and service.batcher.stats["admits"] == 1
        assert sum(len(c) for c in chunks) % SAMPLES_PER_TOKEN == 0
        _run_stream(service, "take the lane", inference_head_num=1)
        assert service.continuous_requests == 1 and service.batcher.stats["admits"] == 1
    finally:
        service.shutdown()


def test_seeded_stream_is_the_same_on_both_routes(tiny):
    """extra_params.seed: the lane and the slots draw the same sources, so
    the PCM agrees within 2 int16 steps (the slots' one-row burst and
    multi-row steps round alike in f32 here)."""
    engine, frontend = tiny
    pcm = []
    for slots in (0, 2):
        service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=slots)
        try:
            chunks, _ = _run_stream(service, "the same seed twice", seed=11)
        finally:
            service.shutdown()
        pcm.append(np.concatenate(chunks).astype(np.int32))
    assert pcm[0].shape == pcm[1].shape and len(pcm[0]) > 0
    assert np.abs(pcm[0] - pcm[1]).max() <= 2


@pytest.mark.parametrize("slots", [0, 2], ids=["window", "continuous"])
def test_two_segment_stream_has_its_pause(tiny, slots):
    """Each segment streams in turn, with 50-150 ms of silence between."""
    engine, frontend = tiny
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=slots)
    try:
        chunks, _ = _run_stream(service, TWO_SEGMENTS, seed=3)
        assert (service.continuous_requests == 1) == (slots > 0)
    finally:
        service.shutdown()
    pauses = [i for i, c in enumerate(chunks) if 0.05 * 24000 <= len(c) <= 0.15 * 24000
              and not c.any()]
    assert len(pauses) == 1 and 0 < pauses[0] < len(chunks) - 1
    for part in (chunks[:pauses[0]], chunks[pauses[0] + 1:]):
        assert sum(len(c) for c in part) % SAMPLES_PER_TOKEN == 0
