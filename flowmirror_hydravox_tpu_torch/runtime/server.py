"""HTTP serving layer, a port of flowmirror_hydravox_tpu/runtime/server.py
(every route), with the reference's REST schema (server/router.py):

  GET  /health            -> {"status": "ok"}
  GET  /                  -> the web UI (runtime/webui.py) as text/html with
                             `with_ui`, else as /health
  GET  /api/v1/speakers   -> {success, message, data: {speakers}, error}
  GET  /api/v1/metrics    -> {success, message, data: {requests, latency_*,
                             batched_requests, continuous_requests,
                             admission_ms_p50/p95, queue_wait_ms_p50/p95}, error}
  POST /api/v1/tts        {text, speaker_id, extra_params, last_prompt}
       -> {success, message, data: {audio_base64, sample_rate, duration}, error}
  POST /api/v1/zero-shot  {tts_text, prompt_text, prompt_audio_base64, mode,
                           extra_params}, mode zero_shot (default),
                           cross_lingual or instruct2 -> as /api/v1/tts
  POST /api/v1/vc         {source_audio_base64, prompt_audio_base64} -> as /api/v1/tts
  POST /api/v1/speakers/add {speaker_id, audio_base64 | dataset_dir, prompt_text}
       -> {..., data: {speaker_id[, rows_averaged]}}
  POST /api/v1/speakers/remove/<id> -> 200, or 404 for an unknown speaker
  POST /api/v1/tts/stream {text, speaker_id, extra_params}
       -> a WAV stream: a RIFF header with 0xFFFFFFFF sizes, then s16le PCM
          chunks (~1 s each, 50-150 ms of silence between segments) until
          the connection closes
  POST /api/v1/load_pt    {llm_pt, flow_pt} -> hot reload of the reference's
                           .pt weights into the live engine -> {..., data:
                           {llm, flow}: the paths loaded}
  GET  /api/v1/devices    -> {..., data: {platform, device_count, devices,
                             default_backend}}: the torch device census
  GET  /api/v1/samples    -> {..., data: {root, samples}} (runtime/samples.py)
  POST /api/v1/samples/load {path} -> {..., data: {audio_base64, prompt_text}};
                           a path outside the samples root -> 400
  POST /api/v1/training/start {train_data, model_type llm|flow|hift|dpo,
                           output_dir, model_checkpoint, batch_size, ...} ->
                           {..., data: {training_id, log_path}}; 400 without
                           train_data or while a training runs
  POST /api/v1/training/stop/<id> -> 200, or 404 for an unknown id
  GET  /api/v1/training/status/<id> -> {..., data: {training_id, status,
                           model_type, output_dir, elapsed_s, new_log,
                           returncode}}; 404 for an unknown id
  GET  /api/v1/training/list -> {..., data: {trainings: [{id, status,
                           model_type, output_dir}]}}
  GET  /api/v1/training/plot/<id> -> image/png (runtime/training_plots.py);
                           404 for an unknown id, 500 when rendering fails
  GET  /api/v1/models/list -> {..., data: {root, models}} (runtime/models_admin.py)
  POST /api/v1/models/delete {path} -> 400 without a path or for one outside
                           the models root, 404 when missing
  POST /api/v1/models/convert {action import|average|graft-mtp, model, src |
                           inputs, dst, tiny} -> a job in the training
                           registry; 400 on a bad request
  POST /api/v1/data/run   {stage 1-5, input_dir, output_dir, ...} -> a
                           preprocessing stage as a job in the training
                           registry, {..., data: {training_id, log_path}};
                           400 for another stage or without the directories

The training, convert and data-stage jobs are subprocesses of the server's
`TrainingManager` (runtime/training_manager.py), which the launcher builds
for its --device and --tiny.

Errors: unknown speaker -> 500 naming the speakers; bad JSON, a stream
without text or speaker_id, zero-shot without prompt audio, voice conversion
without either audio, a speaker to add without an id or audio or dataset, a
bad dataset, a bad sample path -> 400; unknown route -> 404; timeout (of a
stream: before its first chunk) -> 408; a stream that fails after its first
chunk is cut short. Requests take the JAX server's routes:

  - continuous batching (`continuous_slots` > 0, the launcher's default): a
    tts request, or a plain-mode zero-shot request, at the default sampling
    and the slots' head count bypasses the worker queue (server.py:797-826);
    each of its segments becomes one request of the `ContinuousBatcher`
    (runtime/continuous.py), with its prompt and tts-portion length, which
    joins a decode in flight at the next chunk boundary, and the segments'
    wavs are joined with 50-150 ms pauses. A segment longer than the slots'
    ladders sends the whole request to the worker before anything is
    admitted. Cross-lingual and instruct2 requests (an LM prefix other than
    the flow's prompt) take the worker; so do zero-shot requests at the
    zero-shot default sampling (win_size 32), which is not the slots';
  - streams (server.py:143-169, :815-822): a default-config stream rides
    the slots too (`ContinuousBatcher.submit(stream=True)`, one slot
    request per segment, the first `continuous_reserve_stream` slots kept
    for streams); any other stream, every stream in window mode, and a
    stream with a segment past the slots' ladders go to a stream lane of
    two threads of its own (`StreamingSynthesizer`), so that a stream never
    queues behind /tts work in the worker;
  - every other request goes through the queue to one worker thread:
    - a single-segment text, and each segment of a `last_prompt` text, goes
      through `Engine.synthesize`, with its speed; with `last_prompt` each
      segment's tokens and mel are the next one's zero-shot prompt;
    - zero-shot alone (each segment through `Engine.synthesize`) and voice
      conversion (`Engine.voice_convert`, never coalesced);
    - a multi-segment text goes through one flash batch,
      `Engine.synthesize_batch`, whatever its speed (the JAX server passes
      no speed there either), with 50-150 ms pauses between segments;
    - window coalescing: when the worker takes a batchable request (tts
      with no rolling prompt, or zero-shot in any mode, at speed 1), it
      pulls further requests of the same sampling and head count for up to
      `batch_window` s, `max_batch` in all, and serves the group as one
      flash batch with per-row speaker embeddings, prompts, LM prefixes and
      tts-portion lengths (`_prepare_batch_rows`). A request that does not
      match ends the window and runs right after the group, in arrival
      order. With `continuous_slots=0` this is the JAX launcher's
      `--continuous-batching 0` mode.

An integer `seed` in extra_params (an addition to the JAX schema) makes a
request reproducible: segment j draws its sampling and vocoder noise from
`seed + j` (voice conversion its vocoder noise from `seed`), on a slot or as
a row of a flash batch (`noise.RowNoise`), so the same seeded load decodes
the same draws in both modes; a stream's segment j
derives its two sources from `seed + j` (`Engine.stream_noise`) on either
route.
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue
import random
import struct
import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import SamplingConfig
from ..convert import torch_import
from ..noise import RowNoise
from ..ops.sampling import SamplingParams
from ..utils.wavio import audio_to_base64, load_audio_from_base64
from . import models_admin, samples
from .continuous import ContinuousBatcher
from .engine import Engine
from .profiling import MetricsAggregator
from .training_manager import TrainingManager
from .training_plots import generate_training_plot
from .webui import INDEX_HTML

logger = logging.getLogger("hydravox.server")

DEFAULT_TTS_EXTRA = {"top_p": 0.9, "top_k": 10, "win_size": 24, "tau_r": 0.2,
                     "speed": 1.0, "inference_head_num": 2}
DEFAULT_ZS_EXTRA = {"top_p": 0.9, "top_k": 10, "win_size": 32, "tau_r": 0.2,
                    "speed": 1.0, "inference_head_num": 2}


def _pause(sr: int) -> np.ndarray:
    """The random 50-150 ms pause between segments (infer_speech_model.py)."""
    return np.zeros(int(random.uniform(0.05, 0.15) * sr), np.float32)


def _with_pauses(wavs, sr: int) -> np.ndarray:
    """Segments joined with pauses."""
    pieces = []
    for i, w in enumerate(wavs):
        pieces.append(w)
        if i < len(wavs) - 1:
            pieces.append(_pause(sr))
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


def _pcm(wav: np.ndarray) -> bytes:
    """A stream chunk as s16le bytes."""
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_stream_header(sr: int) -> bytes:
    """The RIFF header of a live WAV stream: 0xFFFFFFFF sizes, mono s16le
    (server.py:1335-1339)."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


class TTSService:
    """Queue + worker thread around the Engine, and the continuous slots.

    `batch_window` / `max_batch`: cross-request coalescing of batchable
    requests into one flash batch (see the module docstring); 0 turns it
    off. Left out from the JAX service: the power-of-two row padding, the
    warm-shape keys and the cold-batch fallback (server.py:310-335,
    :363-412), which exist to reuse XLA compile shapes; PyTorch runs
    eagerly, so a group is served at its own row count.

    `continuous_slots` > 0 turns on continuous batching (server.py:100-140):
    a `ContinuousBatcher` of that many slots at the default sampling and
    `continuous_head_num` heads, which becomes the service's default head
    count (the HTTP handler merges the defaults under the client's values,
    so otherwise no request would match the slots), with its first
    `continuous_reserve_stream` slots kept for streams. Its requests run on a
    pool of max(8, 2 x slots) threads that featurise, submit and wait. On an
    engine with spec_decode the slots draft and verify too, so every route
    keeps the heads=1 output distribution; slots at one head have nothing to
    draft with and are refused (server.py:107-112, :128-130)."""

    def __init__(self, engine: Engine, frontend, request_timeout: float = 60.0,
                 batch_window: float = 0.03, max_batch: int = 8,
                 continuous_slots: int = 0, continuous_head_num: int = 2,
                 continuous_reserve_stream: int = 1):
        self.engine = engine
        self.frontend = frontend
        self.timeout = request_timeout
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.batched_requests = 0  # requests served through a coalesced group
        self.continuous_requests = 0  # requests served through the continuous slots
        self.metrics = MetricsAggregator()
        # submit -> worker dequeue (the slots report admission_lat_s instead)
        self.queue_wait_s: deque = deque(maxlen=512)
        self.default_extra = dict(DEFAULT_TTS_EXTRA)
        self.tasks: "queue.Queue" = queue.Queue()
        self.results: Dict[str, Any] = {}
        self.results_lock = threading.Lock()
        self._stop = threading.Event()
        self.batcher = None
        self._continuous_key = None
        self._cont_pool = None
        if continuous_slots > 0 and engine.spec_decode and continuous_head_num < 2:
            raise ValueError("--spec-decode with --continuous-batching needs "
                             "--continuous-heads >= 2 (heads 1..K-1 draft, head 0 verifies)")
        if continuous_slots > 0:
            self.default_extra["inference_head_num"] = int(continuous_head_num)
            default = self._sampling(self.default_extra)
            self._continuous_key = (default, int(continuous_head_num))
            self.batcher = ContinuousBatcher(
                engine, slots=continuous_slots, head_num=continuous_head_num,
                sampling=SamplingParams.make(default.top_p, default.top_k, default.win_size,
                                             default.tau_r),
                reserve_stream_slots=continuous_reserve_stream, spec_decode=engine.spec_decode)
            self._cont_pool = ThreadPoolExecutor(max_workers=max(8, 2 * continuous_slots),
                                                 thread_name_prefix="continuous")
        # the worker launches on the device's default stream, as the
        # batcher's threads do (see ContinuousBatcher.submit)
        self.worker = threading.Thread(target=self._worker_loop, daemon=True)
        self.worker.start()
        # the stream lane (server.py:143-169): two threads, so that two
        # concurrent streams do not wait on each other either
        self.stream_tasks: "queue.Queue" = queue.Queue()
        self._stream_workers = [threading.Thread(target=self._stream_worker_loop, daemon=True)
                                for _ in range(2)]
        for t in self._stream_workers:
            t.start()

    def _stream_worker_loop(self):
        while not self._stop.is_set():
            try:
                task = self.stream_tasks.get(timeout=0.1)
            except queue.Empty:
                continue
            self.queue_wait_s.append(time.time() - task["t_submit"])
            self._process_tts_stream(task)

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                task = self.tasks.get(timeout=0.1)
            except queue.Empty:
                continue
            self.queue_wait_s.append(time.time() - task["t_submit"])
            group, leftover = [task], None
            if self.batch_window > 0 and self._batchable(task) is not None:
                more, leftover = self._coalesce_more(task)
                group += more
            if len(group) > 1:
                self._run_group(group)
            else:
                self._run_one(task)
            if leftover is not None:
                # the non-matching task pulled while coalescing runs now, in
                # arrival order, not behind newer traffic
                self._run_one(leftover)

    def _set_result(self, task: dict, result: dict):
        with self.results_lock:
            self.results[task["task_id"]] = result

    def _run_one(self, task: dict):
        try:
            result = self._process(task)
        except Exception as e:  # the error flows back through the result
            logger.exception("task %s failed", task["task_id"])
            result = {"error": str(e)}
        self._set_result(task, result)

    @staticmethod
    def _sampling(extra: dict) -> SamplingConfig:
        return SamplingConfig(
            top_p=float(extra.get("top_p", 0.9)),
            top_k=int(extra.get("top_k", 10)),
            win_size=int(extra.get("win_size", 24)),
            tau_r=float(extra.get("tau_r", 0.2)),
        )

    def _batchable(self, task: dict) -> Optional[tuple]:
        """The coalescing key (sampling, head count) of a tts task with no
        rolling prompt or of a zero-shot task (any mode), at speed 1, else
        None (server.py:206-228); malformed extra_params give None and fail
        later as the task's own error."""
        kind = task.get("type")
        if not (kind == "zero_shot" or (kind == "tts" and not task.get("last_prompt"))):
            return None
        extra = task.get("extra_params") or {}
        try:
            if float(extra.get("speed", 1.0)) != 1.0:
                return None
            return self._sampling(extra), int(extra.get("inference_head_num", 2))
        except (TypeError, ValueError):
            return None

    def _coalesce_more(self, first: dict) -> tuple:
        """Pull more same-key tasks for up to batch_window s (server.py:245-265).
        Returns (group_tail, leftover): a non-matching task ends the window
        and is handed back to run right after the group."""
        key = self._batchable(first)
        group = []
        deadline = time.time() + self.batch_window
        while len(group) + 1 < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                cand = self.tasks.get(timeout=remaining)
            except queue.Empty:
                break
            if self._batchable(cand) == key:
                group.append(cand)
            else:
                return group, cand
        return group, None

    def _stream_batchable(self, task: dict) -> Optional[tuple]:
        """The (sampling, head count) of a stream task, which rides the slots
        when it is theirs (server.py:230-243); streams have no speed or
        rolling prompt."""
        if task.get("type") != "tts_stream":
            return None
        try:
            extra = task.get("extra_params") or {}
            return self._sampling(extra), int(extra.get("inference_head_num", 2))
        except (TypeError, ValueError):
            return None

    def _stream_noise(self, task: dict, segment: int):
        """Segment j's stream sources: from seed + j when the task carries a
        seed, else from the engine's generator."""
        seed = (task.get("extra_params") or {}).get("seed")
        return self.engine.stream_noise(None if seed is None else int(seed) + segment)

    def _stream_features(self, task: dict) -> list:
        """The frontend features of each segment of a stream task."""
        segments = self.frontend.text_normalize(task["text"], split=True)
        return [self.frontend.frontend_sft(seg, task["speaker_id"]) for seg in segments]

    def _put_stream(self, task: dict, feats_list: list, chunks):
        """Each segment's waveform chunks (`chunks(i, feats)`) as s16le bytes
        on the task's queue, with pauses between segments."""
        q, sr = task["chunk_queue"], self.engine.cfg.sample_rate
        for i, feats in enumerate(feats_list):
            for wav in chunks(i, feats):
                q.put(_pcm(wav))
            if i < len(feats_list) - 1:
                q.put(_pcm(_pause(sr)))

    def _process_tts_stream(self, task: dict):
        """A stream on the stream lane (server.py:743-780): each segment
        through `StreamingSynthesizer.synthesize_stream`; an error goes on
        the queue, then None."""
        try:
            extra = task.get("extra_params") or {}
            sampling, head_num = self._sampling(extra), int(extra.get("inference_head_num", 2))
            self._put_stream(task, self._stream_features(task), lambda i, feats: (
                self.engine.streaming().synthesize_stream(
                    text_tokens=feats["text_tokens"], tts_text_len=feats["tts_text_len"],
                    sampling=sampling, inference_head_num=head_num,
                    prompt_speech_tokens=feats.get("prompt_speech_tokens"),
                    prompt_mel=feats.get("prompt_mel"),
                    spk_embedding=feats.get("spk_embedding"),
                    noise=self._stream_noise(task, i))))
            task["chunk_queue"].put(None)
        except Exception as e:  # the error flows back through the stream
            logger.exception("stream task %s failed", task["task_id"])
            task["chunk_queue"].put(e)
            task["chunk_queue"].put(None)

    def _noises(self, task: dict, n_rows: int) -> list:
        """The noise sources of a task's n_rows segments: seed + j for
        segment j when its extra_params carry a seed, else None (the
        engine's next source)."""
        seed = (task.get("extra_params") or {}).get("seed")
        if seed is None:
            return [None] * n_rows
        return [self.engine.noise_for(int(seed) + j) for j in range(n_rows)]

    def _batch_noise(self, noises: list):
        """One flash batch's noise: a source per row if any row is seeded,
        else None (one source for the batch, as the JAX flash batch has)."""
        if all(n is None for n in noises):
            return None
        return RowNoise([self.engine.next_noise() if n is None else n for n in noises])

    def _prepare_batch_rows(self, task: dict) -> list:
        """One task's rows for the batched routes (server.py:848-895), one
        per segment: (text tokens, tts-portion length, LM prefix or None,
        prompt tokens or None, prompt mel or None, embedding (192,)). A tts
        task's segments share its speaker's prompt (server.py:827-846); a
        zero-shot task's rows are its mode's features from the request's
        audio, as alone (`_zero_shot_features`): the tts-portion length
        leaves out the prompt text, and cross-lingual and instruct2 rows
        carry an empty LM prefix."""
        if task["type"] == "zero_shot":
            return [(np.asarray(f["text_tokens"], np.int32).reshape(-1), int(f["tts_text_len"]),
                     f.get("llm_prompt_speech_tokens"), f.get("prompt_speech_tokens"),
                     f.get("prompt_mel"),
                     np.asarray(f["spk_embedding"], np.float32).reshape(-1)[:192])
                    for f in self._zero_shot_features(task)]
        segments = self.frontend.text_normalize(task["text"], split=True)
        feats0 = self.frontend.frontend_sft(segments[0], task["speaker_id"])
        rows = [feats0["text_tokens"]] + [self.frontend.extract_text_tokens(s)
                                          for s in segments[1:]]
        emb = np.asarray(feats0["spk_embedding"], np.float32).reshape(-1)[:192]
        sp_t, pm_t = feats0.get("prompt_speech_tokens"), feats0.get("prompt_mel")
        return [(np.asarray(tt, np.int32).reshape(-1), len(tt), None, sp_t, pm_t, emb)
                for tt in rows]

    def _run_group(self, group: list):
        """One flash batch for the coalesced tasks (server.py:267-361): the
        rows are every task's segments, with per-row speaker embeddings,
        prompts, LM prefixes and tts-portion lengths; each task gets its own
        rows back, joined with pauses. A task whose featurisation fails gets
        its error; if the batch fails, every task in it gets the batch's
        error."""
        extra = group[0].get("extra_params") or {}
        spans, rows, noises = [], [], []
        for task in group:
            try:
                task_rows = self._prepare_batch_rows(task)
                noises += self._noises(task, len(task_rows))
            except Exception as e:
                logger.exception("task %s failed", task["task_id"])
                self._set_result(task, {"error": str(e)})
                continue
            spans.append((task, len(rows), len(rows) + len(task_rows)))
            rows += task_rows
        if not spans:
            return
        token_rows, tts_lens, llm_rows, sp_rows, pm_rows, embs = zip(*rows)
        try:
            wavs, stats = self.engine.synthesize_batch(
                list(token_rows), sampling=self._sampling(extra),
                inference_head_num=int(extra.get("inference_head_num", 2)),
                prompt_speech_tokens=list(sp_rows), prompt_mel=list(pm_rows),
                spk_embedding=np.stack(embs), noise=self._batch_noise(noises),
                tts_text_lens=list(tts_lens), llm_prompt_speech_tokens=list(llm_rows),
            )
        except Exception as e:
            logger.exception("coalesced batch failed")
            for task, _, _ in spans:
                self._set_result(task, {"error": str(e)})
            return
        self.batched_requests += len(spans)
        logger.info("coalesced %d requests (%d rows) rtf=%.4f", len(spans), len(token_rows),
                    stats["rtf"])
        sr = self.engine.cfg.sample_rate
        for task, start, end in spans:
            self._set_result(task, {"output_audio": _with_pauses(wavs[start:end], sr),
                                    "sample_rate": sr})

    def _synthesize_one(self, feats: dict, sampling, head_num: int, speed: float, noise):
        """One segment through `Engine.synthesize` (server.py:782-795)."""
        res = self.engine.synthesize(
            text_tokens=feats["text_tokens"],
            tts_text_len=feats["tts_text_len"],
            sampling=sampling,
            inference_head_num=head_num,
            prompt_speech_tokens=feats.get("prompt_speech_tokens"),
            prompt_mel=feats.get("prompt_mel"),
            spk_embedding=feats.get("spk_embedding"),
            speed=speed,
            noise=noise,
            llm_prompt_speech_tokens=feats.get("llm_prompt_speech_tokens"),
        )
        self.metrics.record(res)
        return res

    def _zero_shot_features(self, task: dict) -> list:
        """The frontend features of each segment of a zero-shot task, by its
        mode (server.py:648-665); an unknown mode is plain zero-shot."""
        wav, sr = task["prompt_audio"], task["prompt_sample_rate"]
        mode = task.get("mode", "zero_shot")
        segments = self.frontend.text_normalize(task["tts_text"], split=True)
        if mode == "cross_lingual":
            return [self.frontend.frontend_cross_lingual(seg, wav, sr) for seg in segments]
        if mode == "instruct2":
            return [self.frontend.frontend_instruct2(seg, task["prompt_text"], wav, sr)
                    for seg in segments]
        prompt = self.frontend.text_normalize(task["prompt_text"], split=False)[0]
        return [self.frontend.frontend_zero_shot(seg, prompt, wav, sr) for seg in segments]

    def _process(self, task: dict) -> dict:
        """One task alone (server.py:637-741):
          - voice conversion: the frontend, then `Engine.voice_convert`;
          - zero-shot: each segment through `synthesize`, the wavs joined
            with no pause, as in the JAX server;
          - tts: a multi-segment text through one flash batch (which takes
            no speed); with `last_prompt`, or a single segment, each segment
            through `synthesize` with its speed, joined with pauses; with
            `last_prompt`, each segment's tokens and mel are the next one's
            zero-shot prompt (:721-741)."""
        extra = task.get("extra_params") or {}
        sampling = self._sampling(extra)
        head_num = int(extra.get("inference_head_num", 2))
        speed = float(extra.get("speed", 1.0))
        sr = self.engine.cfg.sample_rate
        kind = task.get("type", "tts")
        if kind == "vc":
            feats = self.frontend.frontend_vc(task["source_audio"], task["source_sample_rate"],
                                              task["prompt_audio"], task["prompt_sample_rate"])
            audio = self.engine.voice_convert(
                feats["source_speech_tokens"], feats["prompt_speech_tokens"],
                feats["prompt_mel"], feats["spk_embedding"], noise=self._noises(task, 1)[0])
            return {"output_audio": audio, "sample_rate": sr}
        if kind == "zero_shot":
            feats_list = self._zero_shot_features(task)
            wavs = [self._synthesize_one(feats, sampling, head_num, speed, noise).audio
                    for feats, noise in zip(feats_list, self._noises(task, len(feats_list)))]
            return {"output_audio": np.concatenate(wavs) if wavs else np.zeros(0, np.float32),
                    "sample_rate": sr}
        if kind != "tts":
            raise ValueError(f"unknown task type {kind}")
        segments = self.frontend.text_normalize(task["text"], split=True)
        last_prompt = bool(task.get("last_prompt"))
        if len(segments) > 1 and not last_prompt:
            feats0 = self.frontend.frontend_sft(segments[0], task["speaker_id"])
            wavs, _ = self.engine.synthesize_batch(
                [self.frontend.extract_text_tokens(s) for s in segments],
                sampling=sampling,
                inference_head_num=head_num,
                prompt_speech_tokens=feats0.get("prompt_speech_tokens"),
                prompt_mel=feats0.get("prompt_mel"),
                spk_embedding=feats0.get("spk_embedding"),
                noise=self._batch_noise(self._noises(task, len(segments))),
            )
            return {"output_audio": _with_pauses(wavs, sr), "sample_rate": sr}
        wavs, prev = [], {}
        for segment, noise in zip(segments, self._noises(task, len(segments))):
            feats = {**self.frontend.frontend_sft(segment, task["speaker_id"]), **prev}
            res = self._synthesize_one(feats, sampling, head_num, speed, noise)
            wavs.append(res.audio)
            if last_prompt:
                mel = self.frontend.extract_mel(res.audio, sr)
                n = min(len(res.speech_tokens), mel.shape[0] // 2)
                prev = {"prompt_speech_tokens": res.speech_tokens[:n], "prompt_mel": mel[: 2 * n]}
        return {"output_audio": _with_pauses(wavs, sr), "sample_rate": sr}

    def submit(self, task: dict) -> str:
        tid = str(uuid.uuid4())
        task["task_id"] = tid
        task.setdefault("t_submit", time.time())
        # tts and plain-mode zero-shot ride the slots; cross-lingual and
        # instruct2 need an LM prefix other than the flow's prompt, which a
        # slot does not carry (server.py:797-812)
        continuous_ok = task.get("type") == "tts" or (
            task.get("type") == "zero_shot" and task.get("mode", "zero_shot") == "zero_shot")
        if (self.batcher is not None and continuous_ok
                and self._batchable(task) == self._continuous_key):
            # featurisation, admission and the wait run on a pool thread, so
            # concurrent requests join the shared decode instead of queueing
            # behind the worker
            self._cont_pool.submit(self._run_continuous, task)
        elif self.batcher is not None and self._stream_batchable(task) == self._continuous_key:
            self._cont_pool.submit(self._run_continuous_stream, task)
        elif task.get("type") == "tts_stream":
            self.stream_tasks.put(task)
        else:
            self.tasks.put(task)
        return tid

    def _run_continuous(self, task: dict):
        """Each segment of a tts or plain zero-shot task as one slot request,
        the wavs joined with pauses (server.py:896-944). A segment outside
        the slots' ladders, or one with an LM-prefix override, sends the task
        to the worker before anything is admitted (:906-913)."""
        try:
            rows = self._prepare_batch_rows(task)
            if any(len(tt) > self.batcher.prompt_buckets[-1]
                   or (sp is not None and len(sp) > self.batcher.sp_buckets[-1])
                   or llm_t is not None
                   for tt, _, llm_t, sp, _, _ in rows):
                self.tasks.put(task)
                return
            reqs = [self.batcher.submit(tt, emb, noise=noise, prompt_speech_tokens=sp,
                                        prompt_mel=pm, tts_text_len=tl)
                    for (tt, tl, _, sp, pm, emb), noise in zip(rows,
                                                               self._noises(task, len(rows)))]
            wavs = [self.batcher.result(req, timeout=self.timeout)[0] for req in reqs]
            result = {"output_audio": _with_pauses(wavs, self.engine.cfg.sample_rate),
                      "sample_rate": self.engine.cfg.sample_rate}
            with self.results_lock:
                self.continuous_requests += 1
        except Exception as e:  # the error flows back through the result
            logger.exception("continuous task %s failed", task["task_id"])
            result = {"error": str(e)}
        self._set_result(task, result)

    def _run_continuous_stream(self, task: dict):
        """A stream on the slots (server.py:946-995): each segment one
        stream=True slot request, its chunks on the task's queue as they are
        synthesised, pauses between segments, then None. A segment outside
        the slots' ladders sends the task to the stream lane before anything
        is queued."""
        try:
            feats_list = self._stream_features(task)
            for feats in feats_list:
                sp = feats.get("prompt_speech_tokens")
                if len(feats["text_tokens"]) > self.batcher.prompt_buckets[-1] or (
                        sp is not None and len(sp) > self.batcher.sp_buckets[-1]):
                    self.stream_tasks.put(task)
                    return

            def chunks(i, feats):
                req = self.batcher.submit(
                    feats["text_tokens"], feats.get("spk_embedding"),
                    noise=self._stream_noise(task, i),
                    prompt_speech_tokens=feats.get("prompt_speech_tokens"),
                    prompt_mel=feats.get("prompt_mel"), stream=True,
                    tts_text_len=feats["tts_text_len"])
                return self.batcher.stream_result(req, timeout=self.timeout)

            self._put_stream(task, feats_list, chunks)
            with self.results_lock:  # counted before the reader sees the end
                self.continuous_requests += 1
            task["chunk_queue"].put(None)
        except Exception as e:  # the error flows back through the stream
            logger.exception("continuous stream task %s failed", task["task_id"])
            task["chunk_queue"].put(e)
            task["chunk_queue"].put(None)

    def wait(self, tid: str) -> dict:
        """Poll for the result (router.py:248-295: 50 ms poll, timeout)."""
        deadline = time.time() + self.timeout
        while time.time() < deadline:
            with self.results_lock:
                if tid in self.results:
                    return self.results.pop(tid)
            time.sleep(0.05)
        raise TimeoutError("tts timeout")

    def shutdown(self):
        self._stop.set()
        # cancel queued continuous tasks before the batcher goes, so that no
        # pool thread submits into a stopped batcher (server.py:1007-1014)
        if self._cont_pool is not None:
            self._cont_pool.shutdown(wait=False, cancel_futures=True)
        if self.batcher is not None:
            self.batcher.shutdown()
        for thread in [self.worker] + self._stream_workers:
            thread.join(timeout=5)

    def load_pt(self, llm_pt: Optional[str] = None, flow_pt: Optional[str] = None) -> dict:
        """Hot reload of the reference's llm.pt / flow.pt into the live
        engine (server.py:1381-1398), each leaf at the live leaf's dtype.
        With slots, the trees are swapped between two of the batcher's
        ticks. Returns {model: path} of what was loaded."""
        paths = {name: path for name, path in (("llm", llm_pt), ("flow", flow_pt)) if path}
        trees = {name: torch_import.convert(name, torch_import.load_torch_pt(path),
                                            self.engine.cfg)
                 for name, path in paths.items()}
        self.engine.load_weights(trees, hold=(self.batcher.between_ticks() if self.batcher
                                              else contextlib.nullcontext()))
        logger.info("hot-reloaded %s", paths)
        return paths

    def device_census(self) -> dict:
        """GET /api/v1/devices (server.py:1065-1080): the serving device's
        platform (gpu or cpu) and its devices, where JAX lists jax.devices()."""
        if self.engine.device.type == "cuda":
            names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
            platform = "gpu"
        else:
            names, platform = ["cpu"], "cpu"
        return {"platform": platform, "device_count": len(names), "devices": names,
                "default_backend": str(self.engine.device)}

    def metrics_summary(self) -> dict:
        """The data of GET /api/v1/metrics (server.py:1049-1063)."""
        data = self.metrics.summary()
        data["batched_requests"] = self.batched_requests
        data["continuous_requests"] = self.continuous_requests
        for name, window in (("admission_ms", self.batcher and self.batcher.admission_lat_s),
                             ("queue_wait_ms", self.queue_wait_s)):
            if window:
                lat = np.asarray(window)
                data[f"{name}_p50"] = round(float(np.percentile(lat, 50)) * 1000, 1)
                data[f"{name}_p95"] = round(float(np.percentile(lat, 95)) * 1000, 1)
        return data


def _response(success: bool, message: str, data=None, error=None) -> dict:
    return {"success": success, "message": message, "data": data, "error": error}


class _Handler(BaseHTTPRequestHandler):
    service: TTSService = None  # injected by make_server
    training: TrainingManager = None  # injected by make_server
    with_ui: bool = False  # injected by make_server: GET / answers with the web UI

    def log_message(self, fmt, *args):
        logger.debug(fmt, *args)

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/api/v1/speakers":
            speakers = self.service.frontend.available_speakers()
            self._send(200, _response(True, "ok", data={"speakers": speakers}))
        elif self.path == "/api/v1/metrics":
            self._send(200, _response(True, "ok", data=self.service.metrics_summary()))
        elif self.path == "/api/v1/devices":
            self._send(200, _response(True, "ok", data=self.service.device_census()))
        elif self.path == "/api/v1/samples":
            self._send(200, _response(True, "ok", data={"root": samples.samples_root(),
                                                        "samples": samples.list_samples()}))
        elif self.path.startswith("/api/v1/training/status/"):
            status = self.training.get_training_status(self.path.rsplit("/", 1)[1])
            if status.get("success"):
                self._send(200, _response(True, "ok", data=status))
            else:
                self._send(404, _response(False, "unknown training", error=status.get("error")))
        elif self.path.startswith("/api/v1/training/plot/"):
            self._send_plot(self.path.split("?")[0].rsplit("/", 1)[1])
        elif self.path.startswith("/api/v1/models/list"):
            self._send(200, _response(True, "ok", data={"root": models_admin.models_root(),
                                                        "models": models_admin.list_models()}))
        elif self.path == "/api/v1/training/list":
            self._send(200, _response(True, "ok",
                                      data={"trainings": self.training.list_trainings()}))
        elif self.path == "/" and self.with_ui:
            self._send_ui()
        elif self.path in ("/health", "/"):
            self._send(200, {"status": "ok"})
        else:
            self._send(404, _response(False, "not found", error="not found"))

    def _send_ui(self):
        """GET / with the UI on (server.py:1124-1142)."""
        body = INDEX_HTML.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_plot(self, tid: str):
        """GET /api/v1/training/plot/<id> (server.py:1082-1102)."""
        with self.training.lock:
            entry = self.training.trainings.get(tid)
        if entry is None:
            self._send(404, _response(False, "unknown training", error=tid))
            return
        try:
            with open(generate_training_plot(entry["log_path"], entry["output_dir"]), "rb") as f:
                body = f.read()
        except Exception as e:
            self._send(500, _response(False, "plot failed", error=str(e)))
            return
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_job(self, result: dict, started: str):
        """A job route's answer (server.py:1223-1255): 200 with the result,
        else 400 with its error."""
        ok = bool(result.get("success"))
        self._send(200 if ok else 400, _response(
            ok, started if ok else "failed", data=result if ok else None,
            error=result.get("error")))

    def _handle_delete_model(self, body: dict):
        """POST /api/v1/models/delete (server.py:1206-1222)."""
        if not body.get("path"):
            self._send(400, _response(False, "missing fields", error="path required"))
            return
        try:
            result = models_admin.delete_model(body["path"])
        except ValueError as e:
            self._send(400, _response(False, "bad path", error=str(e)))
            return
        ok = bool(result.get("success"))
        self._send(200 if ok else 404, _response(
            ok, "deleted" if ok else "failed", data=result if ok else None,
            error=result.get("error")))

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
        except Exception as e:
            self._send(400, _response(False, "bad request", error=str(e)))
            return
        try:
            if self.path == "/api/v1/tts":
                self._handle_tts(body)
            elif self.path == "/api/v1/tts/stream":
                self._handle_tts_stream(body)
            elif self.path == "/api/v1/zero-shot":
                self._handle_zero_shot(body)
            elif self.path == "/api/v1/vc":
                self._handle_vc(body)
            elif self.path == "/api/v1/speakers/add":
                self._handle_add_speaker(body)
            elif self.path.startswith("/api/v1/speakers/remove/"):
                self._handle_remove_speaker()
            elif self.path == "/api/v1/load_pt":
                self._send(200, _response(True, "loaded", data=self.service.load_pt(
                    body.get("llm_pt"), body.get("flow_pt"))))
            elif self.path == "/api/v1/samples/load":
                self._handle_load_sample(body)
            elif self.path == "/api/v1/models/delete":
                self._handle_delete_model(body)
            elif self.path == "/api/v1/models/convert":
                self._send_job(models_admin.convert_model(body, self.training), "convert started")
            elif self.path == "/api/v1/data/run":
                self._send_job(self.training.start_data_stage(body), "stage started")
            elif self.path == "/api/v1/training/start":
                self._send_job(self.training.start_training(body), "training started")
            elif self.path.startswith("/api/v1/training/stop/"):
                result = self.training.stop_training(self.path.rsplit("/", 1)[1])
                self._send(200 if result.get("success") else 404, _response(
                    result.get("success", False), "stopped", error=result.get("error")))
            else:
                self._send(404, _response(False, "not found", error="not found"))
        except TimeoutError:
            self._send(408, _response(False, "timeout", error="tts timeout"))
        except Exception as e:
            logger.exception("request failed")
            self._send(500, _response(False, "error", error=str(e)))

    def _finish_audio(self, result: dict):
        if "error" in result:
            self._send(500, _response(False, "synthesis failed", error=result["error"]))
            return
        audio, sr = result["output_audio"], result["sample_rate"]
        self._send(200, _response(
            True, "ok",
            data={
                "audio_base64": audio_to_base64(audio, sr),
                "sample_rate": sr,
                "duration": float(len(audio)) / sr,
            },
        ))

    def _handle_tts(self, body: dict):
        extra = {**self.service.default_extra, **(body.get("extra_params") or {})}
        tid = self.service.submit({
            "type": "tts",
            "text": body.get("text", ""),
            "speaker_id": body.get("speaker_id"),
            "last_prompt": body.get("last_prompt", False),
            "extra_params": extra,
        })
        self._finish_audio(self.service.wait(tid))

    def _handle_zero_shot(self, body: dict):
        """POST /api/v1/zero-shot (server.py:1349-1365): tts_text, prompt_text,
        prompt_audio_base64 and a mode (zero_shot, cross_lingual, instruct2)."""
        if not body.get("prompt_audio_base64"):
            self._send(400, _response(False, "missing prompt audio",
                                      error="prompt_audio_base64 required"))
            return
        wav, sr = load_audio_from_base64(body["prompt_audio_base64"])
        tid = self.service.submit({
            "type": "zero_shot",
            "tts_text": body.get("tts_text", ""),
            "prompt_text": body.get("prompt_text", ""),
            "prompt_audio": wav,
            "prompt_sample_rate": sr,
            "mode": body.get("mode", "zero_shot"),
            "extra_params": {**DEFAULT_ZS_EXTRA, **(body.get("extra_params") or {})},
        })
        self._finish_audio(self.service.wait(tid))

    def _handle_vc(self, body: dict):
        """POST /api/v1/vc (server.py:1367-1379): source_audio_base64 re-voiced
        with the timbre of prompt_audio_base64."""
        if not body.get("source_audio_base64") or not body.get("prompt_audio_base64"):
            self._send(400, _response(False, "missing audio",
                                      error="source_audio_base64 + prompt_audio_base64 required"))
            return
        src, src_sr = load_audio_from_base64(body["source_audio_base64"])
        pw, pw_sr = load_audio_from_base64(body["prompt_audio_base64"])
        tid = self.service.submit({
            "type": "vc",
            "source_audio": src, "source_sample_rate": src_sr,
            "prompt_audio": pw, "prompt_sample_rate": pw_sr,
            "extra_params": body.get("extra_params") or {},
        })
        self._finish_audio(self.service.wait(tid))

    def _handle_add_speaker(self, body: dict):
        """POST /api/v1/speakers/add (server.py:1172-1199): from audio_base64
        (embedding and zero-shot prompt), or as the mean embedding over a
        dataset on disk (dataset_dir); prompt_text is optional."""
        frontend = self.service.frontend
        spk = body.get("speaker_id")
        if not spk or not (body.get("audio_base64") or body.get("dataset_dir")):
            self._send(400, _response(False, "missing fields",
                                      error="speaker_id + (audio_base64 or dataset_dir) required"))
            return
        if body.get("dataset_dir"):
            try:
                n = frontend.add_speaker_from_dataset(spk, body["dataset_dir"],
                                                      prompt_text=body.get("prompt_text"))
            except (ValueError, FileNotFoundError) as e:
                self._send(400, _response(False, "bad dataset", error=str(e)))
                return
            self._send(200, _response(True, "speaker added",
                                      data={"speaker_id": spk, "rows_averaged": n}))
            return
        wav, sr = load_audio_from_base64(body["audio_base64"])
        frontend.add_speaker_from_audio(spk, wav, sr, prompt_text=body.get("prompt_text"))
        self._send(200, _response(True, "speaker added", data={"speaker_id": spk}))

    def _handle_remove_speaker(self):
        """POST /api/v1/speakers/remove/<id> (server.py:1200-1205): 404 for an
        unknown speaker."""
        spk = self.path.rsplit("/", 1)[1]
        ok = self.service.frontend.remove_speaker(spk)
        self._send(200 if ok else 404, _response(
            ok, "removed" if ok else "unknown speaker",
            error=None if ok else f"unknown speaker {spk}"))

    def _handle_load_sample(self, body: dict):
        """POST /api/v1/samples/load (server.py:1161-1171): one sample's audio
        and transcript; a path outside the samples root or missing -> 400."""
        try:
            data = samples.load_sample(str(body.get("path", "")))
        except ValueError as e:
            self._send(400, _response(False, "bad sample path", error=str(e)))
            return
        self._send(200, _response(True, "ok", data=data))

    def _handle_tts_stream(self, body: dict):
        """A live WAV over the response body (server.py:1298-1347): the RIFF
        header with unknown sizes, then PCM chunks as they are synthesised;
        the connection closes at the end of the utterance."""
        if not body.get("text") or not body.get("speaker_id"):
            self._send(400, _response(False, "missing fields",
                                      error="text + speaker_id required"))
            return
        # the service's defaults: with the slots on, a default stream rides them
        extra = {**self.service.default_extra, **(body.get("extra_params") or {})}
        chunk_q: "queue.Queue" = queue.Queue()
        self.service.submit({"type": "tts_stream", "text": body["text"],
                             "speaker_id": body["speaker_id"], "extra_params": extra,
                             "chunk_queue": chunk_q})
        try:
            chunk = chunk_q.get(timeout=self.service.timeout)
        except queue.Empty:
            self._send(408, _response(False, "timeout", error="tts timeout"))
            return
        if isinstance(chunk, Exception):
            self._send(500, _response(False, "synthesis failed", error=str(chunk)))
            return
        sr = self.service.engine.cfg.sample_rate
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("X-Sample-Rate", str(sr))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(wav_stream_header(sr))
        while chunk is not None and not isinstance(chunk, Exception):
            self.wfile.write(chunk)
            self.wfile.flush()
            try:
                chunk = chunk_q.get(timeout=self.service.timeout)
            except queue.Empty:
                break  # a stalled stream ends here; the client sees it cut short


def make_server(host: str, port: int, engine: Engine, frontend, request_timeout: float = 60.0,
                batch_window: float = 0.03, max_batch: int = 8, continuous_slots: int = 0,
                continuous_head_num: int = 2, continuous_reserve_stream: int = 1,
                training: Optional[TrainingManager] = None,
                with_ui: bool = False) -> ThreadingHTTPServer:
    """The HTTP server; `training` is the job registry of the training and
    model routes (default: one whose trainers run on the engine's device);
    `with_ui` serves the web UI at GET / (server.py:1411-1421)."""
    service = TTSService(engine, frontend, request_timeout=request_timeout,
                         batch_window=batch_window, max_batch=max_batch,
                         continuous_slots=continuous_slots,
                         continuous_head_num=continuous_head_num,
                         continuous_reserve_stream=continuous_reserve_stream)
    training = training or TrainingManager(device=engine.device.type)
    handler = type("Handler", (_Handler,), {"service": service, "training": training,
                                            "with_ui": with_ui})
    return ThreadingHTTPServer((host, port), handler)


def serve(host: str, port: int, engine: Engine, frontend, request_timeout: float = 60.0,
          continuous_slots: int = 0, continuous_head_num: int = 2,
          continuous_reserve_stream: int = 1, training: Optional[TrainingManager] = None,
          with_ui: bool = False):
    server = make_server(host, port, engine, frontend, request_timeout=request_timeout,
                         continuous_slots=continuous_slots,
                         continuous_head_num=continuous_head_num,
                         continuous_reserve_stream=continuous_reserve_stream,
                         training=training, with_ui=with_ui)
    logger.info("serving on %s:%d (ui=%s, continuous_slots=%d, reserved for streams %d)", host,
                port, with_ui, continuous_slots,
                continuous_reserve_stream if continuous_slots else 0)
    try:
        server.serve_forever()
    finally:
        server.RequestHandlerClass.service.shutdown()
        server.RequestHandlerClass.training.stop_all()
        server.server_close()
