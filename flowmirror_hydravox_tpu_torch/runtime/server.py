"""HTTP serving layer, SFT subset of flowmirror_hydravox_tpu/runtime/server.py,
with the reference's REST schema (server/router.py):

  GET  /health            -> {"status": "ok"}
  GET  /api/v1/speakers   -> {success, message, data: {speakers}, error}
  POST /api/v1/tts        {text, speaker_id, extra_params}
       -> {success, message, data: {audio_base64, sample_rate, duration}, error}

Errors: unknown speaker -> 500 naming the speakers; bad JSON -> 400; unknown
route -> 404; timeout -> 408. Requests run on one worker thread (one device
program stream), and take the JAX server's routes:

  - a single-segment text goes through `Engine.synthesize`, with its speed;
  - a multi-segment text goes through one flash batch,
    `Engine.synthesize_batch`, whatever its speed (the JAX server passes no
    speed there either), with 50-150 ms pauses between segments;
  - window coalescing: when the worker takes a batchable request (SFT tts,
    speed 1, no rolling prompt), it pulls further requests of the same
    sampling and head count for up to `batch_window` s, `max_batch` in all,
    and serves the group as one flash batch with per-row speaker
    embeddings. A request that does not match ends the window and runs
    right after the group, in arrival order. This is the JAX launcher's
    `--continuous-batching 0` mode; the continuous batcher is not ported.
"""

from __future__ import annotations

import json
import logging
import queue
import random
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from ..config import SamplingConfig
from ..utils.wavio import audio_to_base64
from .engine import Engine

logger = logging.getLogger("hydravox.server")

DEFAULT_TTS_EXTRA = {"top_p": 0.9, "top_k": 10, "win_size": 24, "tau_r": 0.2,
                     "speed": 1.0, "inference_head_num": 2}


def _with_pauses(wavs, sr: int) -> np.ndarray:
    """Segments joined with random 50-150 ms pauses (infer_speech_model.py)."""
    pieces = []
    for i, w in enumerate(wavs):
        pieces.append(w)
        if i < len(wavs) - 1:
            pieces.append(np.zeros(int(random.uniform(0.05, 0.15) * sr), np.float32))
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


class TTSService:
    """Queue + worker thread around the Engine.

    `batch_window` / `max_batch`: cross-request coalescing of batchable
    requests into one flash batch (see the module docstring); 0 turns it
    off. Left out from the JAX service: the power-of-two row padding, the
    warm-shape keys and the cold-batch fallback (server.py:310-335,
    :363-412), which exist to reuse XLA compile shapes; PyTorch runs
    eagerly, so a group is served at its own row count."""

    def __init__(self, engine: Engine, frontend, request_timeout: float = 60.0,
                 batch_window: float = 0.03, max_batch: int = 8):
        self.engine = engine
        self.frontend = frontend
        self.timeout = request_timeout
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.batched_requests = 0  # requests served through a coalesced group
        self.default_extra = dict(DEFAULT_TTS_EXTRA)
        self.tasks: "queue.Queue" = queue.Queue()
        self.results: Dict[str, Any] = {}
        self.results_lock = threading.Lock()
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._worker_loop, daemon=True)
        self.worker.start()

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                task = self.tasks.get(timeout=0.1)
            except queue.Empty:
                continue
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
        """The coalescing key (sampling, head count) of an SFT tts task at
        speed 1 with no rolling prompt, else None (server.py:206-228);
        malformed extra_params give None and fail later as the task's own
        error."""
        if task.get("type") != "tts" or task.get("last_prompt"):
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

    def _sft_rows(self, task: dict):
        """(text token rows, speaker embedding, prompt tokens, prompt mel) of
        one tts task, one row per segment (server.py:827-846)."""
        segments = self.frontend.text_normalize(task["text"], split=True)
        feats0 = self.frontend.frontend_sft(segments[0], task["speaker_id"])
        rows = [feats0["text_tokens"]] + [self.frontend.extract_text_tokens(s)
                                          for s in segments[1:]]
        emb = np.asarray(feats0["spk_embedding"], np.float32).reshape(-1)[:192]
        return rows, emb, feats0.get("prompt_speech_tokens"), feats0.get("prompt_mel")

    def _run_group(self, group: list):
        """One flash batch for the coalesced tasks (server.py:267-361): the
        rows are every task's segments, with per-row speaker embeddings and
        prompts; each task gets its own rows back, joined with pauses. A
        task whose featurisation fails gets its error; if the batch fails,
        every task in it gets the batch's error."""
        extra = group[0].get("extra_params") or {}
        spans, token_rows, embs, sp_rows, pm_rows = [], [], [], [], []
        for task in group:
            try:
                rows, emb, sp_t, pm_t = self._sft_rows(task)
            except Exception as e:
                logger.exception("task %s failed", task["task_id"])
                self._set_result(task, {"error": str(e)})
                continue
            spans.append((task, len(token_rows), len(token_rows) + len(rows)))
            token_rows += rows
            embs += [emb] * len(rows)
            sp_rows += [sp_t] * len(rows)
            pm_rows += [pm_t] * len(rows)
        if not spans:
            return
        try:
            wavs, stats = self.engine.synthesize_batch(
                token_rows, sampling=self._sampling(extra),
                inference_head_num=int(extra.get("inference_head_num", 2)),
                prompt_speech_tokens=sp_rows, prompt_mel=pm_rows, spk_embedding=np.stack(embs),
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

    def _process(self, task: dict) -> dict:
        """One task alone (server.py:687-741): a multi-segment text through
        one flash batch (which takes no speed), a single segment through
        `synthesize` with its speed."""
        extra = task.get("extra_params") or {}
        sampling = self._sampling(extra)
        head_num = int(extra.get("inference_head_num", 2))
        speed = float(extra.get("speed", 1.0))
        sr = self.engine.cfg.sample_rate
        segments = self.frontend.text_normalize(task["text"], split=True)
        if len(segments) > 1:
            feats0 = self.frontend.frontend_sft(segments[0], task["speaker_id"])
            wavs, _ = self.engine.synthesize_batch(
                [self.frontend.extract_text_tokens(s) for s in segments],
                sampling=sampling,
                inference_head_num=head_num,
                prompt_speech_tokens=feats0.get("prompt_speech_tokens"),
                prompt_mel=feats0.get("prompt_mel"),
                spk_embedding=feats0.get("spk_embedding"),
            )
            return {"output_audio": _with_pauses(wavs, sr), "sample_rate": sr}
        feats = self.frontend.frontend_sft(segments[0], task["speaker_id"])
        res = self.engine.synthesize(
            text_tokens=feats["text_tokens"],
            tts_text_len=feats["tts_text_len"],
            sampling=sampling,
            inference_head_num=head_num,
            prompt_speech_tokens=feats.get("prompt_speech_tokens"),
            prompt_mel=feats.get("prompt_mel"),
            spk_embedding=feats.get("spk_embedding"),
            speed=speed,
        )
        return {"output_audio": res.audio, "sample_rate": sr}

    def submit(self, task: dict) -> str:
        tid = str(uuid.uuid4())
        task["task_id"] = tid
        self.tasks.put(task)
        return tid

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
        self.worker.join(timeout=5)


def _response(success: bool, message: str, data=None, error=None) -> dict:
    return {"success": success, "message": message, "data": data, "error": error}


class _Handler(BaseHTTPRequestHandler):
    service: TTSService = None  # injected by make_server

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
        elif self.path in ("/health", "/"):
            self._send(200, {"status": "ok"})
        else:
            self._send(404, _response(False, "not found", error="not found"))

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
        if body.get("last_prompt"):
            # the rolling zero-shot prompt needs the prompt-mel frontend
            self._send(400, _response(False, "unsupported",
                                      error="last_prompt is not supported by this server"))
            return
        extra = {**self.service.default_extra, **(body.get("extra_params") or {})}
        tid = self.service.submit({
            "type": "tts",
            "text": body.get("text", ""),
            "speaker_id": body.get("speaker_id"),
            "extra_params": extra,
        })
        self._finish_audio(self.service.wait(tid))


def make_server(host: str, port: int, engine: Engine, frontend, request_timeout: float = 60.0,
                batch_window: float = 0.03, max_batch: int = 8) -> ThreadingHTTPServer:
    service = TTSService(engine, frontend, request_timeout=request_timeout,
                         batch_window=batch_window, max_batch=max_batch)
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(host: str, port: int, engine: Engine, frontend, request_timeout: float = 60.0):
    server = make_server(host, port, engine, frontend, request_timeout=request_timeout)
    logger.info("serving on %s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
