"""Continuous (in-flight) batching for the multi-head LM decode: a port of
flowmirror_hydravox_tpu/runtime/continuous.py, whole utterances and streams,
blind multi-head slots and speculative ones.

A fixed set of decode slots shares one KV cache of (L, slots, cache_cap,
Hkv, D). New requests are admitted into free slots between chunks: they join
a decode already in flight instead of waiting for a whole batch to drain (the
window mode of runtime/server.py).

  - Admission prefills one request's prompt into its slot's row of the shared
    cache, in place: the row is zeroed, the prompt block written from
    position 0 and its length set, as the JAX admit writes a fresh one-row
    cache over the row (:283-318).
  - A chunk runs up to CHUNK_STEPS group-decode steps over all slots
    (`llm.decode_step_batched`: the MTP heads once over all slots, the
    batched RAS draw, one backbone forward in which finished and empty slots
    advance 0 and keep their hidden state) and stops early once every slot
    has finished. A step after which every slot has finished runs no forward.
  - Finished rows leave their slots and are synthesised (flow + HiFT over
    TOKEN_BUCKETS, `Engine.synthesize_tokens`) on the same thread, before the
    next admission and chunk.

Streams (`submit(stream=True)`, :444-529, :1181-1337) ride the same slots:

  - Admission runs the prefill and a decode burst of ceil((hop + lookahead
    (+ hop - 1 with prompt speech)) / K) steps on a one-row state over the
    slot's cache row, then writes the row into the slot, so the first hop
    exists when admission returns. The burst's steps are the slots' step
    (`llm.decode_step_batched`) on the request's own noise.
  - An SFT stream (no prompt speech, no prompt mel) synthesises its first
    chunk right after the burst, with the int16 output rule of the JAX fused
    admit (:531-673, :1106-1123; see runtime/streaming.py).
  - Every full hop a stream slot accumulates becomes a chunk, then the final
    flush (`_emit_stream_row`), with the solo streamer's chunk semantics
    (`StreamingSynthesizer._token2wav`). Syntheses run in priority order:
    first chunks, later chunks first in first out, then whole utterances.
  - `reserve_stream_slots` keeps the first N slots for streams; a stream in
    the backlog goes before whole utterances, but after
    `stream_fairness_k` stream admissions in a row with whole utterances
    waiting, one of those goes first (:122-164, :993-1021).

The JAX batcher synthesises on threads of its own (:1225-1265), a whole-
utterance thread and a stream-chunk thread with an order gate per stream
(`synth_next`/`synth_cv`), which overlap the device programs of the next
chunk. Here both stages are bound by the host's dispatch of small kernels, so
threads only contend for the interpreter: on an H100 a slot step overlapped
by a second thread's synthesis takes several times as long as one alone, and
so does the synthesis (`tools/profile_decode.py --synth-overlap`; PERF.md).
One thread serves both in turn, and a stream's chunks are synthesised in
order without a gate.

Each request carries its own noise source (`noise.py`; `Engine.next_noise()`
or, for a stream, `Engine.stream_noise()`, unless given): an active slot
draws `noise.sampling(K, vocab)` once per step, a finished or empty slot
draws nothing (it is fed zeros and accepts nothing), and the same source
feeds the request's HiFT draw. That is the JAX per-slot key chain (:364-366,
:1374, :837-841), so a request whose source replays a JAX key decodes the
tokens of `llm.generate` with that key.

`spec_decode=True` (:25-30, :263-271, :319-348, :675-770) makes the slots
draft with MTP heads 1..K-1 and verify against head 0, the exact heads=1
output distribution: the admission draws the request's first token from
head 0 (`noise.spec_first`), each chunk step is `llm.spec_step_batched`
over all slots on each active slot's `noise.spec_step` draws, and slots
commit 1..K tokens a step and drift apart. A slot's draws follow the solo
spec loop's, so a request decodes the tokens of `llm.generate_speculative`
on the same source. Streams take the plain admission there, without a
burst (:1035). Each finished request's stats carry its `spec_acceptance`.

Not ported: `prewarm` (:889-, which pays XLA compiles; the port runs
eagerly).
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..models import llm as llm_model
from ..models import qwen2
from ..ops.sampling import SamplingParams, nucleus_kmax
from .engine import MAX_TOKEN_TEXT_RATIO, MIN_TOKEN_TEXT_RATIO, PROMPT_BUCKETS, _bucket

logger = logging.getLogger("hydravox.continuous")

CHUNK_STEPS = 8  # decode steps between admissions (the JAX default)
# synthesis order (:1214-1223): a stream's first chunk (time to first audio),
# later stream chunks, whole utterances
PRIO_FIRST_CHUNK, PRIO_CHUNK, PRIO_UTTERANCE = 0, 1, 2


class _Request:
    __slots__ = ("text_tokens", "spk_embedding", "min_len", "max_len", "noise",
                 "prompt_speech_tokens", "prompt_mel", "done", "wav", "stats", "error",
                 "t_submit", "t_admit", "t_decoded",
                 # streams: the chunk queue (float32 wavs, then None), the
                 # first hop's prompt padding, the decode's emission cursor,
                 # the carried flow/HiFT state, the first chunk's time and
                 # each chunk's (synthesis s, samples)
                 "stream", "chunk_q", "prompt_pad", "sched_offset", "hift_cache", "t_first",
                 "chunks",
                 # speculative slots: (accepted, drafted) drafts at the finish
                 "spec_pair")

    def __init__(self, text_tokens, spk_embedding, min_len, max_len, noise,
                 prompt_speech_tokens, prompt_mel, stream=False, prompt_pad=0):
        self.text_tokens = text_tokens
        self.spk_embedding = spk_embedding
        self.min_len = min_len
        self.max_len = max_len
        self.noise = noise
        self.prompt_speech_tokens = prompt_speech_tokens
        self.prompt_mel = prompt_mel
        self.done = threading.Event()
        self.wav = None
        self.stats = None
        self.error = None
        self.t_submit = time.time()
        self.t_admit = None  # when it took a slot
        self.t_decoded = None  # when its decode finished and it left the slot
        self.stream = stream
        self.chunk_q = queue.Queue() if stream else None
        self.prompt_pad = prompt_pad
        self.sched_offset = 0
        self.hift_cache = None
        self.t_first = None
        self.chunks = []
        self.spec_pair = None

    def fail(self, error: str):
        """End the request with `error`; a stream's reader gets None and
        raises it."""
        self.error = error
        if self.stream:
            self.chunk_q.put(None)
        self.done.set()


class ContinuousBatcher:
    """Fixed-slot continuous decode over an Engine's parameters and device."""

    def __init__(self, engine, slots: int = 4, head_num: int = 4,
                 sampling: Optional[SamplingParams] = None, reserve_stream_slots: int = 0,
                 spec_decode: bool = False):
        """One batcher serves ONE (head_num, sampling) configuration: the
        slots share each step's MTP heads and draw, so requests with another
        head count or sampling go through the Engine's paths instead.
        `reserve_stream_slots` (at most slots - 1) slots take streams only.
        `spec_decode` makes the slots speculative (see the module
        docstring); it needs head_num >= 2."""
        self.engine = engine
        self.cfg = engine.cfg.llm
        self.sampling = sampling or SamplingParams.make()
        self.slots = slots
        self.spec = bool(spec_decode)
        self.head_k = max(1, min(int(head_num), self.cfg.head_num))
        if self.spec and self.head_k < 2:
            raise ValueError("spec_decode slots need head_num >= 2 (heads 1..K-1 draft, "
                             "head 0 verifies)")
        self.max_tokens = engine.max_tokens
        self.streamer = engine.streaming()
        self.reserve_stream_slots = max(0, min(int(reserve_stream_slots), slots - 1))
        self.stream_fairness_k = 4
        self._stream_admits_streak = 0
        # texts up to 128 tokens ride the slots (longer segments go through
        # the worker), prompt speech up to 256 (:169-180 at the engine's
        # ladder)
        self.prompt_buckets = PROMPT_BUCKETS[:3]
        self.sp_buckets = (0,) + tuple(b for b in PROMPT_BUCKETS if b <= 256)
        # the K slack keeps the K uncommitted positions that a slot writes at
        # every step inside the cache (:181-183)
        cap = 2 + self.prompt_buckets[-1] + self.sp_buckets[-1] + self.max_tokens + self.head_k
        self.cache_cap = -(-cap // llm_model.CACHE_ROUND) * llm_model.CACHE_ROUND

        # submit -> slot latencies for /api/v1/metrics
        self.admission_lat_s: deque = deque(maxlen=512)
        # decode work done, for launch predictions: admits (prefills), steps
        # (MTP heads + draw; with spec_decode, draft heads + head 0 on the
        # block), forwards (decode-step backbone blocks), the streams'
        # admission bursts included, and the seconds spent in chunks and in
        # synthesis
        self.stats = dict(admits=0, steps=0, forwards=0, decode_s=0.0, synth_s=0.0)
        self._state = None
        self._slot_req: list = [None] * slots
        self._slot_steps = [0] * slots
        self._backlog: list = []
        self._backlog_stream: list = []
        # syntheses due, (priority, arrival, item), drained after each chunk
        self._synth_heap: list = []
        self._synth_seq = itertools.count()
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._started = False
        self._lock = threading.Lock()
        self._tick_lock = threading.Lock()  # held by the thread for a whole tick
        self._holds_waiting = 0  # callers of between_ticks not yet inside

    @torch.inference_mode()
    def _init_state(self) -> dict:
        """The shared decode state, every slot finished (empty)."""
        bb = self.cfg.backbone
        dtype = self.engine.llm_params["speech_embedding"].dtype
        dev = self.engine.device
        s = self.slots
        cache = qwen2.init_kv_cache(bb, s, self.cache_cap, dtype=dtype, device=dev)
        last_hidden = torch.zeros((s, bb.hidden_size), dtype=dtype, device=dev)
        if self.spec:
            return llm_model.spec_state(cache, last_hidden, [0] * s, [0] * s, [0] * s,
                                        max_tokens=self.max_tokens, head_k=self.head_k,
                                        finished=[True] * s)
        return dict(
            cache=cache, last_hidden=last_hidden,
            tokens=torch.full((s, self.max_tokens + self.head_k), -1, dtype=torch.int32,
                              device=dev),
            num=[0] * s, finished=[True] * s, max_len=[0] * s,
            num_t=torch.zeros(s, dtype=torch.int64, device=dev),
            min_len_t=torch.zeros(s, dtype=torch.int64, device=dev),
        )

    def _prefill_row(self, slot: int, req: _Request):
        """Prefill one request's prompt into `slot`'s zeroed cache row, in
        place. Returns (the row's one-row KVCache view, last hidden (1, H))."""
        eng, cfg = self.engine, self.cfg
        n, lp = len(req.text_tokens), len(req.prompt_speech_tokens)
        text = np.zeros((_bucket(n, self.prompt_buckets),), np.int32)
        text[:n] = req.text_tokens
        sp_pad = np.zeros((_bucket(lp, self.sp_buckets[1:]) if lp else 0,), np.int32)
        sp_pad[:lp] = req.prompt_speech_tokens
        emb, plen = llm_model.build_inference_prompt(
            eng.llm_params, cfg, eng._tensor(text, torch.int32), n,
            eng._tensor(sp_pad, torch.int32), lp)
        cache = self._state["cache"]
        k_row, v_row = cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1]
        k_row.zero_()
        v_row.zero_()
        dev = eng.device
        hidden, row_cache = qwen2.forward_block_with_cache(
            eng.llm_params["backbone"], cfg.backbone, emb[None],
            qwen2.KVCache(k=k_row, v=v_row, length=torch.zeros(1, dtype=torch.int32, device=dev)),
            advance=torch.tensor([plen], dtype=torch.int32, device=dev),
        )
        self.stats["admits"] += 1
        return row_cache, hidden[:, plen - 1]

    def _admit(self, slot: int, req: _Request):
        """Prefill one request into `slot` of the shared state (:283-318)."""
        st = self._state
        row_cache, last_hidden = self._prefill_row(slot, req)
        st["cache"].length[slot] = row_cache.length[0]
        st["last_hidden"][slot] = last_hidden[0]
        st["tokens"][slot] = -1
        st["num_t"][slot] = 0
        st["min_len_t"][slot] = req.min_len
        st["num"][slot], st["max_len"][slot] = 0, req.max_len
        st["finished"][slot] = False  # live only once its row is whole
        if self.spec:
            self._admit_spec(slot, req, row_cache.length, last_hidden)

    def _admit_spec(self, slot: int, req: _Request, length, last_hidden):
        """The spec admission's first token, from head 0 on the prompt hidden
        (:319-348), on the request's `noise.spec_first`: init_spec_state for
        this row."""
        st, dev = self._state, self.engine.device
        st["max_len_t"][slot] = req.max_len
        row = slice(slot, slot + 1)
        llm_model.set_first_tokens(st, *llm_model.spec_first_tokens(
            self.engine.llm_params, self.cfg, last_hidden, st["min_len_t"][row],
            st["max_len_t"][row], self.sampling,
            req.noise.spec_first(self.cfg.vocab_size).to(dev)[None]), rows=row)
        st["cache_pos"][slot] = int(length[0])
        st["accepted"][slot] = st["drafted"][slot] = 0

    def _admit_stream(self, slot: int, req: _Request) -> int:
        """Prefill a stream and run its decode burst on a one-row state over
        the slot's cache row, then write the row into the slot (:444-529).
        Returns the burst's steps."""
        st, k, vocab = self._state, self.head_k, self.cfg.vocab_size
        dev = self.engine.device
        row_cache, last_hidden = self._prefill_row(slot, req)
        row = dict(
            cache=row_cache, last_hidden=last_hidden,
            tokens=torch.full((1, self.max_tokens + k), -1, dtype=torch.int32, device=dev),
            num=[0], finished=[False], max_len=[req.max_len],
            num_t=torch.zeros(1, dtype=torch.int64, device=dev),
            min_len_t=torch.tensor([req.min_len], dtype=torch.int64, device=dev),
        )
        hop, la = self.streamer.token_hop_len, self.engine.cfg.flow.pre_lookahead_len
        need = hop + la + (hop - 1 if len(req.prompt_speech_tokens) else 0)
        steps = 0
        while steps < -(-need // k) and not row["finished"][0]:
            nuc, flat = req.noise.sampling(k, vocab)
            ran = llm_model.decode_step_batched(
                self.engine.llm_params, self.cfg, row, self.sampling, nuc.to(dev)[None],
                flat.to(dev)[None], head_k=k)
            steps += 1
            self.stats["steps"] += 1
            self.stats["forwards"] += int(ran)
        st["cache"].length[slot] = row["cache"].length[0]
        st["last_hidden"][slot] = row["last_hidden"][0]
        st["tokens"][slot] = row["tokens"][0]
        st["num_t"][slot] = row["num_t"][0]
        st["min_len_t"][slot] = req.min_len
        st["num"][slot], st["max_len"][slot] = row["num"][0], req.max_len
        st["finished"][slot] = row["finished"][0]
        return steps

    def _chunk(self):
        """Up to CHUNK_STEPS group-decode steps over all slots (:410-442)."""
        if self.spec:
            return self._spec_chunk()
        st = self._state
        k, vocab = self.head_k, self.cfg.vocab_size
        dev = self.engine.device
        zero_nuc = torch.zeros((k, nucleus_kmax(vocab)), device=dev)
        zero_flat = torch.zeros((k, vocab), device=dev)
        for _ in range(CHUNK_STEPS):
            if all(st["finished"]):
                break
            nuc, flat = [], []
            for i, req in enumerate(self._slot_req):
                if st["finished"][i]:
                    nuc.append(zero_nuc)
                    flat.append(zero_flat)
                    continue
                g_nuc, g_flat = req.noise.sampling(k, vocab)
                nuc.append(g_nuc.to(dev))
                flat.append(g_flat.to(dev))
                self._slot_steps[i] += 1
            ran = llm_model.decode_step_batched(
                self.engine.llm_params, self.cfg, st, self.sampling, torch.stack(nuc),
                torch.stack(flat), head_k=k)
            self.stats["steps"] += 1
            self.stats["forwards"] += int(ran)

    def _spec_chunk(self):
        """Up to CHUNK_STEPS draft-and-verify steps over all slots (:675-770):
        an active slot draws its request's `noise.spec_step`, a finished or
        empty one is fed zeros and emits nothing."""
        st = self._state
        kd, vocab = self.head_k - 1, self.cfg.vocab_size
        dev = self.engine.device
        zeros = (torch.zeros((kd, vocab), device=dev), torch.zeros(kd, device=dev),
                 torch.zeros(vocab, device=dev), torch.zeros(vocab, device=dev))
        for _ in range(CHUNK_STEPS):
            if all(st["finished"]):
                break
            draws = []
            for i, req in enumerate(self._slot_req):
                if st["finished"][i]:
                    draws.append(zeros)
                    continue
                draws.append(tuple(d.to(dev) for d in req.noise.spec_step(kd, vocab)))
                self._slot_steps[i] += 1
            llm_model.spec_step_batched(
                self.engine.llm_params, self.cfg, st, self.sampling,
                tuple(torch.stack(d) for d in zip(*draws)), head_k=self.head_k)
            self.stats["steps"] += 1
            self.stats["forwards"] += 1

    def submit(self, text_tokens: np.ndarray, spk_embedding: Optional[np.ndarray] = None,
               noise=None, prompt_speech_tokens: Optional[np.ndarray] = None,
               prompt_mel: Optional[np.ndarray] = None, stream: bool = False,
               tts_text_len: Optional[int] = None) -> _Request:
        """Queue one utterance for a slot (:797-865); its token-length bounds
        follow `tts_text_len` (default: the text's length), as
        `Engine.synthesize`'s do. `stream=True` makes it a streaming session:
        ~1 s waveform chunks arrive on its queue (`stream_result`) as the slot
        decodes, and its noise (default `Engine.stream_noise()`) is a
        StreamNoise, as the JAX submit splits the key (:837-841)."""
        n = len(text_tokens)
        if n > self.prompt_buckets[-1]:
            # silent truncation would garble the audio: such prompts go
            # through the Engine's full bucket ladder
            raise ValueError(f"prompt of {n} tokens exceeds the continuous slots' largest "
                             f"bucket {self.prompt_buckets[-1]}; use Engine.synthesize")
        sp = (np.zeros((0,), np.int32) if prompt_speech_tokens is None
              else np.asarray(prompt_speech_tokens, np.int32))
        if len(sp) > self.sp_buckets[-1]:
            raise ValueError(f"prompt speech of {len(sp)} tokens exceeds bucket "
                             f"{self.sp_buckets[-1]}; use Engine.synthesize")
        if self._stop.is_set():
            raise RuntimeError("batcher shut down")
        if noise is None:
            noise = self.engine.stream_noise() if stream else self.engine.next_noise()
        n_ratio = n if tts_text_len is None else int(tts_text_len)
        req = _Request(
            np.asarray(text_tokens, np.int32), spk_embedding, int(n_ratio * MIN_TOKEN_TEXT_RATIO),
            min(int(n_ratio * MAX_TOKEN_TEXT_RATIO), self.max_tokens), noise, sp, prompt_mel,
            stream=stream, prompt_pad=-len(sp) % self.streamer.token_hop_len if stream else 0)
        with self._lock:
            if not self._started:
                self._started = True
                self._state = self._init_state()
                # The batcher's thread and the server's worker both launch on
                # the device's default stream: both kernels merge their
                # splits through one ticket buffer per device
                # (ops/nvcc_build.ticket_buffer), so every call on a device
                # must be ordered on one stream.
                self._thread.start()
        self._pending.put(req)
        return req

    def result(self, req: _Request, timeout: float = 600.0):
        """(wav, stats) of a submitted request; raises its error."""
        if not req.done.wait(timeout):
            raise TimeoutError("continuous decode timeout")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.wav, req.stats

    def stream_result(self, req: _Request, timeout: float = 600.0):
        """Yield the float32 waveform chunks of a stream=True request until
        its end (:874-887); raises if the session failed."""
        if not req.stream:
            raise ValueError("stream_result on a non-stream request")
        while True:
            item = req.chunk_q.get(timeout=timeout)
            if item is None:
                if req.error is not None:
                    raise RuntimeError(req.error)
                return
            if isinstance(item, Exception):
                raise item
            yield item

    @contextlib.contextmanager
    def between_ticks(self):
        """Hold the batcher between two ticks: no slot admits, decodes or
        synthesises until the block ends (a weight reload swaps the engine's
        trees here, so that no slot steps on half-swapped weights). The
        thread waits after its tick while a caller waits here, since a lock
        handed back at once would starve the caller."""
        with self._lock:
            self._holds_waiting += 1
        with self._tick_lock:
            with self._lock:
                self._holds_waiting -= 1
            yield

    def _loop(self):
        while not self._stop.is_set():
            while self._holds_waiting:
                time.sleep(0.001)
            try:
                with self._tick_lock:
                    self._tick()
            except Exception as e:  # the thread keeps serving; in-slot requests fail
                logger.exception("continuous batcher tick failed")
                with self._lock:
                    for i, req in enumerate(self._slot_req):
                        if req is not None:
                            req.fail(str(e))
                            self._slot_req[i] = None
                    self._state = self._init_state()
                time.sleep(0.1)

    def _next_admission(self, slot: int) -> Optional[_Request]:
        """The backlog request that takes free `slot`, if any (:1002-1021):
        streams first, whole utterances only outside the reserved slots, and
        one whole utterance after stream_fairness_k streams in a row while
        it waits."""
        backlog_turn = (self._backlog and slot >= self.reserve_stream_slots
                        and (not self._backlog_stream
                             or self._stream_admits_streak >= self.stream_fairness_k))
        if backlog_turn:
            self._stream_admits_streak = 0
            return self._backlog.pop(0)
        if self._backlog_stream:
            if self._backlog:
                self._stream_admits_streak += 1
            return self._backlog_stream.pop(0)
        return None

    @torch.inference_mode()
    def _tick(self):
        """Admit backlog requests into free slots, run one chunk, and
        synthesise what became due, in priority order (:993-1179)."""
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            (self._backlog_stream if req.stream else self._backlog).append(req)
        for i in range(self.slots):
            if self._slot_req[i] is not None:
                continue
            req = self._next_admission(i)
            if req is None:
                continue
            req.t_admit = time.time()
            self.admission_lat_s.append(req.t_admit - req.t_submit)
            try:
                # spec slots admit streams without the burst (:1035)
                steps = (self._admit_stream(i, req) if req.stream and not self.spec
                         else self._admit(i, req))
            except Exception as e:  # fails only this request; the slot stays empty
                logger.exception("admit failed")
                req.fail(str(e))
                continue
            self._slot_req[i] = req
            self._slot_steps[i] = steps or 0
            if req.stream:
                self._start_stream(i, req)

        if any(r is not None for r in self._slot_req):
            t0 = time.time()
            self._chunk()
            chunk_time = time.time() - t0
            self.stats["decode_s"] += chunk_time
            st = self._state
            for i, req in enumerate(self._slot_req):
                if req is None:
                    continue
                if req.stream:
                    self._emit_stream_row(i, req, chunk_time)
                elif st["finished"][i]:
                    req.t_decoded = time.time()
                    self._record_spec(i, req)
                    num = st["num"][i]
                    logger.info("slot %d decode done: %d tokens in %d steps (%.2fs since "
                                "submit)", i, num, self._slot_steps[i],
                                req.t_decoded - req.t_submit)
                    self._queue_synth(PRIO_UTTERANCE, (
                        "utterance", req, st["tokens"][i].clone(), num, self._slot_steps[i],
                        chunk_time))
                    self._slot_req[i] = None
        elif not self._synth_heap:
            try:  # idle: wait briefly for the next arrival
                req = self._pending.get(timeout=0.05)
                (self._backlog_stream if req.stream else self._backlog).append(req)
            except queue.Empty:
                pass
            return
        self._drain_synth()

    def _queue_synth(self, prio: int, item: tuple):
        heapq.heappush(self._synth_heap, (prio, next(self._synth_seq), item))

    def _drain_synth(self):
        """Synthesise everything due, by priority, then in arrival order."""
        while self._synth_heap:
            item = heapq.heappop(self._synth_heap)[2]
            if item[0] == "chunk":
                self._synth_stream_chunk(*item[1:])
            else:
                self._synthesize(*item[1:])

    def _start_stream(self, i: int, req: _Request):
        """After a stream's admission burst: an SFT stream's first chunk at
        once, with the fused admit's int16 output rule (:1101-1130); then
        whatever the burst made due."""
        hop, la = self.streamer.token_hop_len, self.engine.cfg.flow.pre_lookahead_len
        sft = not len(req.prompt_speech_tokens) and (req.prompt_mel is None
                                                     or len(req.prompt_mel) == 0)
        if sft and self._state["num"][i] >= hop + la:
            tokens = self._state["tokens"][i, :hop + la].cpu().numpy()
            self._synth_stream_chunk(req, tokens, 0, False, self._slot_steps[i], 0.0,
                                     quantize=True)
            req.sched_offset = hop
        self._emit_stream_row(i, req, 0.0)

    def _emit_stream_row(self, i: int, req: _Request, chunk_time: float):
        """Queue every full hop a stream slot has accumulated (the solo
        streamer's chunk boundaries), then, once its decode has finished, the
        final flush, and free the slot (:1181-1212)."""
        st = self._state
        num, steps = st["num"][i], self._slot_steps[i]
        hop, la = self.streamer.token_hop_len, self.engine.cfg.flow.pre_lookahead_len
        row = None
        while True:
            this_hop = hop + req.prompt_pad if req.sched_offset == 0 else hop
            if num - req.sched_offset < this_hop + la:
                break
            if row is None:
                row = st["tokens"][i, :num].cpu().numpy()
            self._queue_stream_chunk(req, row[:req.sched_offset + this_hop + la], False,
                                     steps, chunk_time)
            req.sched_offset += this_hop
        if st["finished"][i]:
            req.t_decoded = time.time()
            self._record_spec(i, req)
            logger.info("slot %d stream decode done: %d tokens in %d steps (%.2fs since "
                        "submit)", i, num, steps, req.t_decoded - req.t_submit)
            tokens = row if row is not None else st["tokens"][i, :num].cpu().numpy()
            self._queue_stream_chunk(req, tokens, True, steps, chunk_time)
            self._slot_req[i] = None

    def _record_spec(self, i: int, req: _Request):
        """A finished spec slot's (accepted, drafted) drafts (:1164-1167)."""
        if self.spec:
            req.spec_pair = (self._state["accepted"][i], self._state["drafted"][i])

    @staticmethod
    def _add_spec_stats(req: _Request):
        """The request's acceptance rate into its stats (:1258-1262)."""
        if req.spec_pair is not None:
            acc, drafted = req.spec_pair
            req.stats["spec_acceptance"] = acc / drafted if drafted else 0.0

    def _queue_stream_chunk(self, req: _Request, tokens, finalize: bool, steps: int,
                            chunk_time: float):
        prio = PRIO_FIRST_CHUNK if req.sched_offset == 0 else PRIO_CHUNK
        self._queue_synth(prio, ("chunk", req, tokens, req.sched_offset, finalize, steps,
                                 chunk_time))

    def _synth_stream_chunk(self, req: _Request, tokens, token_offset: int, finalize: bool,
                            steps: int, chunk_time: float, quantize: bool = False):
        """One chunk of a stream: the solo streamer's `_token2wav` with the
        request's carried cache (:1267-1337). A failure puts the error, then
        None, on the stream's queue; the later chunks of a failed stream are
        dropped."""
        if req.done.is_set():
            return
        t0 = time.time()
        emb = (np.zeros((192,), np.float32) if req.spk_embedding is None
               else np.asarray(req.spk_embedding, np.float32).reshape(-1)[:192])
        try:
            wav, req.hift_cache = self.streamer._token2wav(
                tokens, req.prompt_speech_tokens, req.prompt_mel, emb, token_offset, req.noise,
                finalize, req.hift_cache, quantize)
            req.chunks.append((time.time() - t0, len(wav)))
            if req.t_first is None:
                req.t_first = time.time()
                logger.info("stream ttft %.0f ms (admitted after %.0f ms)",
                            (req.t_first - req.t_submit) * 1e3,
                            (req.t_admit - req.t_submit) * 1e3)
            req.chunk_q.put(wav)
            if finalize:
                req.stats = dict(tokens=np.asarray(tokens).tolist(), steps=steps,
                                 latency=time.time() - req.t_submit,
                                 ttft=req.t_first - req.t_submit, chunk_time=chunk_time,
                                 chunks=list(req.chunks))
                self._add_spec_stats(req)
                req.chunk_q.put(None)
                req.done.set()
        except Exception as e:  # the error flows back through the stream
            logger.exception("continuous stream chunk failed")
            req.error = str(e)
            req.chunk_q.put(e)
            req.chunk_q.put(None)
            req.done.set()
        self.stats["synth_s"] += time.time() - t0

    def _synthesize(self, req: _Request, tokens, num: int, steps: int, chunk_time: float):
        """Flow + HiFT of one finished row; a failure fails only its request
        (the whole-utterance branch of `_synth_loop`, :1249-1265)."""
        t0 = time.time()
        try:
            req.wav = self.engine.synthesize_tokens(
                tokens, num, req.noise, req.prompt_speech_tokens, req.prompt_mel,
                req.spk_embedding)
            req.stats = dict(tokens=tokens[:num].tolist(), steps=steps,
                             latency=time.time() - req.t_submit,
                             synth_time=time.time() - t0, chunk_time=chunk_time)
            self._add_spec_stats(req)
        except Exception as e:  # the error flows back through the request
            logger.exception("continuous synth failed")
            req.error = str(e)
        self.stats["synth_s"] += time.time() - t0
        req.done.set()

    def shutdown(self):
        """Stop the thread and fail every request still queued, in a slot or
        waiting for synthesis, so that their waiters (a stream's reader
        included) return now (:1381-1418)."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)
        leftovers = list(self._backlog) + list(self._backlog_stream)
        self._backlog, self._backlog_stream = [], []
        while True:
            try:
                leftovers.append(self._pending.get_nowait())
            except queue.Empty:
                break
        leftovers += [item[2][1] for item in self._synth_heap]
        self._synth_heap = []
        with self._lock:
            for i, req in enumerate(self._slot_req):
                if req is not None:
                    leftovers.append(req)
                    self._slot_req[i] = None
        for req in leftovers:
            if not req.done.is_set():
                req.fail("batcher shut down")
