"""Rolling request metrics for `GET /api/v1/metrics`.

A copy of `MetricsAggregator` from flowmirror_hydravox_tpu/runtime/profiling.py
(:39-72); the JAX module's xplane helpers are not needed here (the port's
traces are torch.profiler's, tools/profile_decode.py)."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

import numpy as np


class MetricsAggregator:
    """Rolling request metrics: p50/p95 latency, RTF, TPS."""

    def __init__(self, window: int = 256):
        self.lock = threading.Lock()
        self.records = deque(maxlen=window)
        self.total_requests = 0
        self.start_time = time.time()

    def record(self, result) -> None:
        """result: runtime.engine.SynthesisResult."""
        with self.lock:
            self.total_requests += 1
            self.records.append(
                dict(total=result.total_time, llm=result.llm_time,
                     synth=result.synth_time, rtf=result.rtf, tps=result.tps,
                     tokens=len(result.speech_tokens))
            )

    def summary(self) -> Dict:
        with self.lock:
            if not self.records:
                return {"requests": self.total_requests}
            arr = {k: np.asarray([r[k] for r in self.records]) for k in self.records[0]}
            return {
                "requests": self.total_requests,
                "uptime_s": round(time.time() - self.start_time, 1),
                "latency_p50_ms": round(float(np.percentile(arr["total"], 50)) * 1000, 1),
                "latency_p95_ms": round(float(np.percentile(arr["total"], 95)) * 1000, 1),
                "rtf_p50": round(float(np.percentile(arr["rtf"], 50)), 4),
                "tps_p50": round(float(np.percentile(arr["tps"], 50)), 1),
                "llm_ms_p50": round(float(np.percentile(arr["llm"], 50)) * 1000, 1),
                "synth_ms_p50": round(float(np.percentile(arr["synth"], 50)) * 1000, 1),
            }
