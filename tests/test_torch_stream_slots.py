"""Streams on the port's continuous slots (tiny config, f32), held against the
port's own solo streamer (itself held against JAX in
tests/test_torch_streaming.py) on the same sources, as the JAX
tests/test_continuous.py holds its stream slots: the same chunks of the same
lengths, exact tokens, the PCM within PCM_STEPS int16 steps.

Also: two concurrent streams, the reserved stream slot, the fairness bound,
first-chunk priority, a failed chunk, shutdown, and the slots' stats (the
admission burst's steps and forwards counted, so launch predictions hold).
The engine's streamer runs at token_hop_len 8, mel_cache_len 4, so that a
short utterance spans several chunks."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.noise import SeededVocoder, StreamNoise, TorchNoise
from flowmirror_hydravox_tpu_torch.ops.sampling import SamplingParams
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.continuous import ContinuousBatcher, _Request
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
from flowmirror_hydravox_tpu_torch.runtime.streaming import StreamingSynthesizer
from tests.torch_port_util import seeded_tiny_trees

CFG = tiny_config()
MAX_TOKENS = 48
PCM_STEPS = 2
TIMEOUT = 120.0
TEXT = (np.arange(10, dtype=np.int32) * 13) % 256
PROMPTED = dict(  # prompt_pad 2: the unfused first chunk on the slots
    prompt_speech_tokens=np.arange(6, dtype=np.int32) * 7 % 50,
    prompt_mel=np.random.default_rng(0).standard_normal((12, 80)).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    trees = [from_numpy_tree(tr, "cpu") for tr in seeded_tiny_trees()]  # sharper draws
    eng = Engine(CFG, *trees, max_tokens=MAX_TOKENS, device="cpu")
    eng._streaming = StreamingSynthesizer(eng, token_hop_len=8, mel_cache_len=4)
    return eng


def _noise(seed):
    """A stream's sources from one seed, made anew for each route."""
    return StreamNoise(TorchNoise(torch.Generator().manual_seed(seed)),
                       SeededVocoder(seed + 1, "cpu"))


def _slots(engine, **kwargs):
    """A batcher at the sampling the solo streamer takes by default."""
    sp = CFG.tts_sampling
    return ContinuousBatcher(engine, sampling=SamplingParams.make(
        sp.top_p, sp.top_k, sp.win_size, sp.tau_r), **kwargs)


@contextlib.contextmanager
def _batcher(engine, **kwargs):
    b = _slots(engine, **kwargs)
    try:
        yield b
    finally:
        b.shutdown()


def _solo(engine, seed, text=TEXT, **kwargs):
    session = {}
    chunks = list(engine.streaming().synthesize_stream(
        text, len(text), inference_head_num=2, noise=_noise(seed), session=session, **kwargs))
    return chunks, session


def _assert_same_stream(got, want):
    assert [len(c) for c in got] == [len(c) for c in want] and len(got) >= 2
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        g16, w16 = ((np.clip(x, -1, 1) * 32767.0).astype(np.int16).astype(np.int32)
                    for x in (g, w))
        assert np.abs(g16 - w16).max() <= PCM_STEPS


@pytest.mark.parametrize("prompted", [False, True], ids=["sft", "prompted"])
def test_slot_stream_matches_solo_stream(engine, prompted):
    kwargs = PROMPTED if prompted else {}
    want, session = _solo(engine, 7, **kwargs)
    with _batcher(engine, slots=2, head_num=2) as b:
        req = b.submit(TEXT, noise=_noise(7), stream=True, tts_text_len=len(TEXT), **kwargs)
        got = list(b.stream_result(req, timeout=TIMEOUT))
    assert req.stats["tokens"] == session["tokens"] and req.error is None
    assert req.prompt_pad == (2 if prompted else 0)
    assert 0 < req.stats["ttft"] <= req.stats["latency"]
    assert len(req.stats["chunks"]) == len(got)
    _assert_same_stream(got, want)


def test_two_concurrent_streams(engine):
    """Two streams on two slots decode side by side; each is its solo stream."""
    texts = [TEXT, (np.arange(7, dtype=np.int32) * 5 + 2) % 256]
    wants = [_solo(engine, 20 + i, text=text) for i, text in enumerate(texts)]
    with _batcher(engine, slots=2, head_num=2) as b:
        # both queued before the batcher's thread starts, so that its first
        # tick admits both: a thread started by the first submit could admit
        # that stream alone and finish it before the second arrives
        b._started = True
        b._state = b._init_state()
        reqs = [b.submit(text, noise=_noise(20 + i), stream=True)
                for i, text in enumerate(texts)]
        b._thread.start()
        outs = [None, None]

        def read(i):
            outs[i] = list(b.stream_result(reqs[i], timeout=TIMEOUT))

        readers = [threading.Thread(target=read, args=(i,)) for i in range(2)]
        for r in readers:
            r.start()
        for r in readers:
            r.join(timeout=TIMEOUT)
        assert not any(r.is_alive() for r in readers)
    assert reqs[1].t_admit < reqs[0].t_decoded  # both were in flight at once
    for req, got, (want, session) in zip(reqs, outs, wants):
        assert req.stats["tokens"] == session["tokens"]
        _assert_same_stream(got, want)


def test_stats_count_the_admission_burst(engine):
    """One stream alone: the slots' stats hold its burst and chunk steps, and
    every step but the stopping one runs a forward, so the launches of both
    kernels follow from them as for whole utterances."""
    with _batcher(engine, slots=2, head_num=2) as b:
        req = b.submit(TEXT, noise=_noise(3), stream=True)
        list(b.stream_result(req, timeout=TIMEOUT))
        stats = dict(b.stats)
    _, session = _solo(engine, 3)
    assert stats["admits"] == 1 and stats["steps"] == req.stats["steps"] == session["steps"]
    assert stats["forwards"] == stats["steps"] - 1
    assert stats["synth_s"] > 0


def _hand_driven(engine, **kwargs):
    """A batcher whose ticks the test drives (its thread never starts)."""
    b = _slots(engine, **kwargs)
    b._started = True
    b._state = b._init_state()
    return b


def test_reserved_slot_takes_a_stream_past_the_backlog(engine):
    """With one slot reserved, whole utterances fill only the other slots; a
    stream that arrives behind them takes the reserved slot at the next
    tick, and utterances never take it."""
    b = _hand_driven(engine, slots=2, head_num=2, reserve_stream_slots=1)
    long_text = np.arange(24, dtype=np.int32)  # min_len 48: several chunks
    try:
        utts = [b.submit(long_text, noise=TorchNoise(torch.Generator().manual_seed(i)))
                for i in range(2)]
        b._tick()
        assert b._slot_req == [None, utts[0]] and b._backlog == [utts[1]]
        stream = b.submit(long_text, noise=_noise(5), stream=True)
        b._tick()
        assert b._slot_req == [stream, utts[0]] and b._backlog == [utts[1]]
        assert stream.chunk_q.qsize() >= 1  # its first chunk came with the admission
    finally:
        b._started = False
        b.shutdown()
    assert all(r.error == "batcher shut down" for r in utts)


def test_fairness_bound(engine):
    """After stream_fairness_k stream admissions in a row with a whole
    utterance waiting, the utterance goes first; reserved slots stay for
    streams."""
    b = ContinuousBatcher(engine, slots=2, head_num=2, reserve_stream_slots=1)
    streams, utt = [f"stream{i}" for i in range(6)], "utterance"
    b._backlog_stream, b._backlog = list(streams), [utt]
    order = [b._next_admission(1) for _ in range(6)]
    assert b.stream_fairness_k == 4
    assert order == streams[:4] + [utt] + streams[4:5]
    b._backlog = ["another"]
    assert b._next_admission(0) == streams[5] and b._next_admission(0) is None
    assert b._backlog == ["another"]  # slot 0 is reserved
    b._backlog = []


def test_first_chunks_go_first(engine, monkeypatch):
    """Syntheses run first chunks first, then later chunks in arrival order,
    then whole utterances."""
    b = ContinuousBatcher(engine, slots=2, head_num=2)
    done = []
    monkeypatch.setattr(b, "_synth_stream_chunk",
                        lambda req, tokens, offset, *rest: done.append((req, offset)))
    monkeypatch.setattr(b, "_synthesize", lambda req, *rest: done.append((req, None)))
    a, c = (_Request(TEXT, None, 20, 48, _noise(0), np.zeros(0, np.int32), None, stream=True)
            for _ in range(2))
    b._queue_synth(2, ("utterance", "u", None, 0, 0, 0.0))
    a.sched_offset = 8
    b._queue_stream_chunk(a, [0] * 19, False, 1, 0.0)
    b._queue_stream_chunk(c, [0] * 11, False, 1, 0.0)
    a.sched_offset = 16
    b._queue_stream_chunk(a, [0] * 27, True, 1, 0.0)
    b._drain_synth()
    assert done == [(c, 0), (a, 8), (a, 16), ("u", None)]
    b.shutdown()


def test_failed_chunk_ends_the_stream_then_the_slots_serve(engine, monkeypatch):
    """A chunk that raises puts its error, then None, on the stream's queue;
    the stream's later chunks are dropped and the next stream is served."""
    streamer = engine.streaming()
    token2wav, calls = streamer._token2wav, []

    def flaky(*args, **kwargs):
        calls.append(args[4])
        if len(calls) == 2:
            raise RuntimeError("injected chunk failure")
        return token2wav(*args, **kwargs)

    monkeypatch.setattr(streamer, "_token2wav", flaky)
    with _batcher(engine, slots=2, head_num=2) as b:
        req = b.submit(TEXT, noise=_noise(9), stream=True)
        got = []
        with pytest.raises(RuntimeError, match="injected chunk failure"):
            for wav in b.stream_result(req, timeout=TIMEOUT):
                got.append(wav)
        assert len(got) == 1 and req.chunk_q.get(timeout=TIMEOUT) is None
        assert req.done.is_set() and req.error == "injected chunk failure"
        nxt = b.submit(TEXT, noise=_noise(10), stream=True)
        assert len(list(b.stream_result(nxt, timeout=TIMEOUT))) >= 2


def test_shutdown_unblocks_stream_result(engine):
    """A reader blocked on a stream in a slot, and one on a stream still in
    the backlog, both return with 'batcher shut down'."""
    b = _hand_driven(engine, slots=1, head_num=2)
    reqs = [b.submit(np.arange(24, dtype=np.int32), noise=_noise(i), stream=True)
            for i in range(2)]
    b._tick()
    assert b._slot_req == [reqs[0]] and b._backlog_stream == [reqs[1]]
    errors = []

    def read(req):
        try:
            list(b.stream_result(req, timeout=60.0))
        except RuntimeError as e:
            errors.append(str(e))

    readers = [threading.Thread(target=read, args=(r,)) for r in reqs]
    for r in readers:
        r.start()
    b._started = False  # no thread to join
    t0 = time.time()
    b.shutdown()
    for r in readers:
        r.join(timeout=10)
    assert not any(r.is_alive() for r in readers) and time.time() - t0 < 10
    assert errors == ["batcher shut down"] * 2
