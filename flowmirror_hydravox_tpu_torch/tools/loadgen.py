# Copied from flowmirror_hydravox_tpu/tools/loadgen.py; the port keeps its own copy.
"""HTTP load generator for a running HydraVox server.

Benchmarks a deployment's serving modes (window coalescing vs continuous
batching vs per-request) under concurrent load, in three traffic shapes:

  --mode tts      (default) non-streaming /tts requests; reports latency
                  percentiles + effective RTF + the server batching counters.
  --mode stream   /tts/stream requests; additionally reports TTFT (time to
                  the first PCM chunk after the WAV header) and inter-chunk
                  cadence percentiles — the serving metric that matters for
                  live playback (reference streaming orchestrator,
                  cli/model.py:279-313).
  --arrival closed|poisson
                  closed = each worker loops back-to-back (throughput probe);
                  poisson --rate R = open-loop staggered arrivals at R req/s
                  across the pool (the continuous-batching design load:
                  queueing delay shows up in the latency percentiles).

Usage:
  python -m flowmirror_hydravox_tpu_torch.tools.loadgen \
      --url http://127.0.0.1:8080 --speaker default \
      --concurrency 8 --duration 30 [--mode stream] \
      [--arrival poisson --rate 4] [--head-num 4] [--text "..."]

Output: one JSON line with the measured fields (nulls where not applicable).
The standard library only: it drives any HydraVox server, the port's or the
JAX package's, with the same requests and the same fields.
"""

from __future__ import annotations

import argparse
import base64
import json
import random
import threading
import time
import urllib.request


def percentile(vals, q: float):
    """The nearest-rank q-quantile of `vals`, in their units."""
    vals = sorted(vals)
    return vals[min(int(q * len(vals)), len(vals) - 1)]


def _tts_once(url: str, payload: bytes, timeout: float):
    req = urllib.request.Request(
        f"{url}/api/v1/tts", payload, {"Content-Type": "application/json"}
    )
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.load(r)
    dt = time.time() - t0
    if not body.get("success"):
        raise RuntimeError(body.get("error") or body.get("message"))
    wav = base64.b64decode(body["data"]["audio_base64"])
    # 44-byte WAV header, s16le mono: duration = (len-44) / 2 / sample_rate
    sr = body["data"].get("sample_rate", 24000)
    return dt, max(len(wav) - 44, 0) / 2 / sr


def _stream_once(url: str, payload: bytes, timeout: float, sr: int = 24000):
    """One /tts/stream request. Returns (total_s, audio_s, ttft_s,
    max_interchunk_gap_s): ttft = first body chunk after the 44-byte
    streaming RIFF header; gaps = wall time between successive chunks."""
    req = urllib.request.Request(
        f"{url}/api/v1/tts/stream", payload, {"Content-Type": "application/json"}
    )
    t0 = time.time()
    ttft = None
    max_gap = 0.0
    n_bytes = 0
    last = t0
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"http {r.status}")
        while True:
            chunk = r.read(32768)
            now = time.time()
            if not chunk:
                break
            n_bytes += len(chunk)
            if ttft is None and n_bytes > 44:  # past the RIFF header
                ttft = now - t0
            else:
                max_gap = max(max_gap, now - last)
            last = now
    total = time.time() - t0
    return total, max(n_bytes - 44, 0) / 2 / sr, ttft if ttft is not None else total, max_gap


def run_load(url: str, payload: bytes, *, mode: str = "tts",
             arrival: str = "closed", rate: float = 4.0, concurrency: int = 8,
             duration: float = 30.0, timeout: float = 120.0, warmup: int = 1,
             seed: int = 0) -> dict:
    """Programmatic load run (tools/bench_serving.py uses this directly).
    Returns the result dict that main() prints."""
    lats, audio, ttfts, gaps, errors = [], [], [], [], []
    lock = threading.Lock()

    def one_request():
        if mode == "stream":
            total, dur, ttft, gap = _stream_once(url, payload, timeout)
            return total, dur, ttft, gap
        dt, dur = _tts_once(url, payload, timeout)
        return dt, dur, None, None

    def record(started_at):
        try:
            total, dur, ttft, gap = one_request()
            lat = time.time() - started_at  # includes open-loop queueing
            with lock:
                lats.append(lat)
                audio.append(dur)
                if ttft is not None:
                    ttfts.append(ttft)
                    gaps.append(gap)
        except Exception as e:
            with lock:
                errors.append(str(e))

    # warmup (compile absorption), untimed
    for _ in range(max(warmup, 0)):
        try:
            one_request()
        except Exception:
            pass

    t0 = time.time()
    stop_at = t0 + duration
    if arrival == "closed":
        def worker():
            while time.time() < stop_at:
                record(time.time())

        threads = [threading.Thread(target=worker) for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:  # poisson open loop: arrivals on schedule; latency includes queueing
        from concurrent.futures import ThreadPoolExecutor

        rng = random.Random(seed)
        futures = []
        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            next_t = t0
            while True:
                next_t += rng.expovariate(rate)
                if next_t >= stop_at:
                    break
                delay = next_t - time.time()
                if delay > 0:
                    time.sleep(delay)
                futures.append(pool.submit(record, next_t))
            for f in futures:
                f.result()
    wall = time.time() - t0

    metrics = {}
    try:
        with urllib.request.urlopen(f"{url}/api/v1/metrics", timeout=10) as r:
            metrics = json.load(r).get("data") or {}
    except Exception:
        pass

    def pct(vals, q):
        return None if not vals else round(percentile(vals, q) * 1000, 1)

    return {
        "mode": mode, "arrival": arrival,
        "rate_rps": rate if arrival == "poisson" else None,
        "requests": len(lats),
        "errors": len(errors),
        "rps": round(len(lats) / max(wall, 1e-9), 2),
        "audio_s_per_s": round(sum(audio) / max(wall, 1e-9), 2),
        "rtf_effective": round(wall / sum(audio), 5) if audio else None,
        "latency_p50_ms": pct(lats, 0.50),
        "latency_p95_ms": pct(lats, 0.95),
        "ttft_p50_ms": pct(ttfts, 0.50),
        "ttft_p95_ms": pct(ttfts, 0.95),
        "interchunk_gap_p95_ms": pct(gaps, 0.95),
        "batched_requests": metrics.get("batched_requests"),
        "continuous_requests": metrics.get("continuous_requests"),
        "first_errors": errors[:3] if errors else None,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--url", default="http://127.0.0.1:8080")
    p.add_argument("--speaker", default="default")
    p.add_argument("--text", default="并发负载测试：新闻播报的语速通常是每分钟两百四十字左右。")
    p.add_argument("--mode", choices=["tts", "stream"], default="tts")
    p.add_argument("--arrival", choices=["closed", "poisson"], default="closed")
    p.add_argument("--rate", type=float, default=4.0,
                   help="poisson arrivals per second (open loop)")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--head-num", type=int, default=None,
                   help="inference_head_num (omit for the server default)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed warmup requests before the window")
    args = p.parse_args(argv)

    extra = {}
    if args.head_num is not None:
        extra["inference_head_num"] = args.head_num
    payload = json.dumps(
        {"text": args.text, "speaker_id": args.speaker, "extra_params": extra}
    ).encode()

    out = run_load(
        args.url, payload, mode=args.mode, arrival=args.arrival, rate=args.rate,
        concurrency=args.concurrency, duration=args.duration,
        timeout=args.timeout, warmup=args.warmup)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
