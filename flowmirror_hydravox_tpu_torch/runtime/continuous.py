"""Continuous (in-flight) batching for the multi-head LM decode: the
non-streaming, non-speculative subset of
flowmirror_hydravox_tpu/runtime/continuous.py.

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

The JAX batcher synthesises on a thread of its own (:1225-1265), which
overlaps the device programs of the next chunk. Here both stages are bound by
the host's dispatch of small kernels, so two threads only contend for the
interpreter: on an H100 a slot step overlapped by a second thread's synthesis
takes several times as long as one alone, and so does the synthesis
(`tools/profile_decode.py --synth-overlap`; PERF.md). One thread serves both
in turn.

Each request carries its own noise source (`noise.py`; `Engine.next_noise()`
unless given): an active slot draws `noise.sampling(K, vocab)` once per step,
a finished or empty slot draws nothing (it is fed zeros and accepts nothing),
and the same source feeds the request's HiFT draw. That is the JAX per-slot
key chain (:364-366, :1374), so a request whose source replays a JAX key
decodes the tokens of `llm.generate` with that key.

Not ported: the stream slots and their lane (:444-, :531-, :1181-, :1267-),
the spec-decode slots (:319-348, :675-) and `prewarm` (:889-, which pays XLA
compiles; the port runs eagerly).
"""

from __future__ import annotations

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


class _Request:
    __slots__ = ("text_tokens", "spk_embedding", "min_len", "max_len", "noise",
                 "prompt_speech_tokens", "prompt_mel", "done", "wav", "stats", "error",
                 "t_submit", "t_admit", "t_decoded")

    def __init__(self, text_tokens, spk_embedding, min_len, max_len, noise,
                 prompt_speech_tokens, prompt_mel):
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


class ContinuousBatcher:
    """Fixed-slot continuous decode over an Engine's parameters and device."""

    def __init__(self, engine, slots: int = 4, head_num: int = 4,
                 sampling: Optional[SamplingParams] = None):
        """One batcher serves ONE (head_num, sampling) configuration: the
        slots share each step's MTP heads and draw, so requests with another
        head count or sampling go through the Engine's paths instead."""
        self.engine = engine
        self.cfg = engine.cfg.llm
        self.sampling = sampling or SamplingParams.make()
        self.slots = slots
        self.head_k = max(1, min(int(head_num), self.cfg.head_num))
        self.max_tokens = engine.max_tokens
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
        # (MTP heads + draw), forwards (decode-step backbone blocks), and the
        # seconds spent in chunks and in synthesis
        self.stats = dict(admits=0, steps=0, forwards=0, decode_s=0.0, synth_s=0.0)
        self._state = None
        self._slot_req: list = [None] * slots
        self._slot_steps = [0] * slots
        self._backlog: list = []
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._started = False
        self._lock = threading.Lock()

    @torch.inference_mode()
    def _init_state(self) -> dict:
        """The shared decode state, every slot finished (empty)."""
        bb = self.cfg.backbone
        dtype = self.engine.llm_params["speech_embedding"].dtype
        dev = self.engine.device
        s = self.slots
        return dict(
            cache=qwen2.init_kv_cache(bb, s, self.cache_cap, dtype=dtype, device=dev),
            last_hidden=torch.zeros((s, bb.hidden_size), dtype=dtype, device=dev),
            tokens=torch.full((s, self.max_tokens + self.head_k), -1, dtype=torch.int32,
                              device=dev),
            num=[0] * s, finished=[True] * s, max_len=[0] * s,
            num_t=torch.zeros(s, dtype=torch.int64, device=dev),
            min_len_t=torch.zeros(s, dtype=torch.int64, device=dev),
        )

    def _admit(self, slot: int, req: _Request):
        """Prefill one request into `slot` of the shared state (:283-318)."""
        eng, cfg = self.engine, self.cfg
        st = self._state
        params = eng.llm_params
        n, lp = len(req.text_tokens), len(req.prompt_speech_tokens)
        text = np.zeros((_bucket(n, self.prompt_buckets),), np.int32)
        text[:n] = req.text_tokens
        sp_pad = np.zeros((_bucket(lp, self.sp_buckets[1:]) if lp else 0,), np.int32)
        sp_pad[:lp] = req.prompt_speech_tokens
        emb, plen = llm_model.build_inference_prompt(
            params, cfg, eng._tensor(text, torch.int32), n, eng._tensor(sp_pad, torch.int32), lp)
        cache = st["cache"]
        k_row, v_row = cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1]
        k_row.zero_()
        v_row.zero_()
        dev = eng.device
        hidden, _ = qwen2.forward_block_with_cache(
            params["backbone"], cfg.backbone, emb[None],
            qwen2.KVCache(k=k_row, v=v_row, length=torch.zeros(1, dtype=torch.int32, device=dev)),
            advance=torch.tensor([plen], dtype=torch.int32, device=dev),
        )
        cache.length[slot] = plen
        st["last_hidden"][slot] = hidden[0, plen - 1]
        st["tokens"][slot] = -1
        st["num_t"][slot] = 0
        st["min_len_t"][slot] = req.min_len
        st["num"][slot], st["max_len"][slot] = 0, req.max_len
        st["finished"][slot] = False  # live only once its row is whole
        self.stats["admits"] += 1

    def _chunk(self):
        """Up to CHUNK_STEPS group-decode steps over all slots (:410-442)."""
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

    def submit(self, text_tokens: np.ndarray, spk_embedding: Optional[np.ndarray] = None,
               noise=None, prompt_speech_tokens: Optional[np.ndarray] = None,
               prompt_mel: Optional[np.ndarray] = None) -> _Request:
        """Queue one utterance for a slot (:797-865); its token-length bounds
        follow the text's length, as `Engine.synthesize`'s do."""
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
        req = _Request(
            np.asarray(text_tokens, np.int32), spk_embedding, int(n * MIN_TOKEN_TEXT_RATIO),
            min(int(n * MAX_TOKEN_TEXT_RATIO), self.max_tokens),
            noise if noise is not None else self.engine.next_noise(), sp, prompt_mel)
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

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # the thread keeps serving; in-slot requests fail
                logger.exception("continuous batcher tick failed")
                with self._lock:
                    for i, req in enumerate(self._slot_req):
                        if req is not None:
                            req.error = str(e)
                            req.done.set()
                            self._slot_req[i] = None
                    self._state = self._init_state()
                time.sleep(0.1)

    @torch.inference_mode()
    def _tick(self):
        """Admit backlog requests into free slots, run one chunk, and
        synthesise the rows that finished in it (:993-1179, non-stream
        part)."""
        while True:
            try:
                self._backlog.append(self._pending.get_nowait())
            except queue.Empty:
                break
        for i in range(self.slots):
            if self._slot_req[i] is not None or not self._backlog:
                continue
            req = self._backlog.pop(0)
            req.t_admit = time.time()
            self.admission_lat_s.append(req.t_admit - req.t_submit)
            try:
                self._admit(i, req)
            except Exception as e:  # fails only this request; the slot stays empty
                logger.exception("admit failed")
                req.error = str(e)
                req.done.set()
                continue
            self._slot_req[i] = req
            self._slot_steps[i] = 0

        if all(r is None for r in self._slot_req):
            try:  # idle: wait briefly for the next arrival
                self._backlog.append(self._pending.get(timeout=0.05))
            except queue.Empty:
                pass
            return

        t0 = time.time()
        self._chunk()
        chunk_time = time.time() - t0
        self.stats["decode_s"] += chunk_time
        st = self._state
        finished = []
        for i, req in enumerate(self._slot_req):
            if req is None or not st["finished"][i]:
                continue
            req.t_decoded = time.time()
            num = st["num"][i]
            logger.info("slot %d decode done: %d tokens in %d steps (%.2fs since submit)",
                        i, num, self._slot_steps[i], req.t_decoded - req.t_submit)
            finished.append((req, st["tokens"][i].clone(), num, self._slot_steps[i]))
            self._slot_req[i] = None
        for req, tokens, num, steps in finished:
            self._synthesize(req, tokens, num, steps, chunk_time)

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
        except Exception as e:  # the error flows back through the request
            logger.exception("continuous synth failed")
            req.error = str(e)
        self.stats["synth_s"] += time.time() - t0
        req.done.set()

    def shutdown(self):
        """Stop the thread and fail every request still queued or in a slot,
        so that their waiters return now (:1381-1418)."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)
        leftovers = list(self._backlog)
        self._backlog = []
        while True:
            try:
                leftovers.append(self._pending.get_nowait())
            except queue.Empty:
                break
        with self._lock:
            for i, req in enumerate(self._slot_req):
                if req is not None:
                    leftovers.append(req)
                    self._slot_req[i] = None
        for req in leftovers:
            if not req.done.is_set():
                req.error = "batcher shut down"
                req.done.set()
