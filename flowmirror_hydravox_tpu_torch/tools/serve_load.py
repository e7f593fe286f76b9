"""Both serving modes under a sustained, seeded load on the card.

    python -m flowmirror_hydravox_tpu_torch.tools.serve_load [--requests 24] \
        [--rates 0.5,1.0,1.5] [--reps 4] [--slots 4] [--max-tokens 1024] [--seed 0]

Needs a CUDA GPU. Builds the engine as the launcher does (default
HydraVoxConfig(), random weights: LLM and flow bf16, HiFT f32). For each rate
it sends `--requests` one-sentence POST /api/v1/tts requests at heads 2 with
Poisson arrivals at that rate, open loop: the gaps come from `--seed`, so
every run of a rate sends the same schedule. Each run gets a fresh server on
127.0.0.1 and one warm-up request before the load: window coalescing
(`--continuous-batching 0`, the 0.03 s window) or `--slots` continuous
slots at heads 2, one of them kept for streams (the launcher's default, so
`--slots` - 1 take this load), in the order window, slots,
slots, window for each pair of reps. Request i of the p-th such group of
four runs carries extra_params seed 1000 (p + 1) + i: both modes draw the
same noise, and each group other noise. The draws decide where a request
stops; on the card the same draws can still end in other tokens on another
route, because bf16 sums round differently at another batch size, so each
run reports the tokens it decoded.

Requests go through tools/loadgen.py's `_tts_once`, and the percentiles
are its nearest-rank ones. Per run: client latency p50/p95/p99/mean/max,
the same of each request's latency over its own speech tokens, the load's
wall time (first send to last answer), speech tokens (from each WAV's
length), tokens/s and audio seconds per second over the load, and the
server's /api/v1/metrics; for the slots also the batcher's ms per slot step and its seconds of decode
and of synthesis. Prints one JSON line per run and writes them all, with the
card's name and power limit, to chiprun_out/serve_load.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time
import urllib.request

import numpy as np
import torch

from .. import __main__ as launcher
from ..runtime.server import make_server
from .loadgen import _tts_once, percentile

TEXTS = ["The first caller asks for a short weather report.",
         "A second caller wants the opening hours of the library.",
         "The third request reads a line from a story for children.",
         "Here the fourth caller orders a taxi to the station.",
         "A fifth voice announces that the train is running late.",
         "The sixth request describes the view from a high window.",
         "Someone asks how long the soup should stay on the stove.",
         "The last caller in the list says goodbye to everyone."]
SEED_BASE = 1000
OUT = os.path.join("chiprun_out", "serve_load.json")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def _tts_samples(base: str, text: str, seed: int, sample_rate: int) -> int:
    """One /api/v1/tts request at heads 2 (loadgen's request); the WAV's
    sample count."""
    payload = json.dumps({"text": text, "speaker_id": "default",
                          "extra_params": {"inference_head_num": 2, "seed": seed}}).encode()
    return round(_tts_once(base, payload, 900.0)[1] * sample_rate)


def _percentiles(name: str, x) -> dict:
    """p50/p95/p99 as loadgen takes them (nearest rank), mean and max."""
    return {**{f"{name}_p{q}": float(percentile(x, q / 100)) for q in (50, 95, 99)},
            f"{name}_mean": float(np.mean(x)), f"{name}_max": float(max(x))}


def run_load(engine, frontend, mode: str, slots: int, gaps, seed_base: int = SEED_BASE) -> dict:
    """One run: a fresh server, a warm-up request, then one request per gap,
    each sent on its own thread after its gap."""
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=900.0,
                         continuous_slots=slots if mode == "slots" else 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    service = server.RequestHandlerClass.service
    sr = engine.cfg.sample_rate
    try:
        _tts_samples(base, "Warm up the server.", 0, sr)
        before = dict(service.batcher.stats) if service.batcher else None
        n = len(gaps)
        out, errors = [None] * n, []

        def one(i):
            t0 = time.time()
            try:
                samples = _tts_samples(base, TEXTS[i % len(TEXTS)], seed_base + i, sr)
                out[i] = (time.time() - t0, samples)
            except Exception as e:  # reported below
                errors.append(f"request {i}: {e}")

        clients = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        t0 = time.time()
        for gap, client in zip(gaps, clients):
            time.sleep(gap)
            client.start()
        for client in clients:
            client.join(timeout=900)
        wall = time.time() - t0
        if errors or any(c.is_alive() for c in clients):
            raise RuntimeError("; ".join(errors) or "a request did not finish")
        metrics = json.load(urllib.request.urlopen(base + "/api/v1/metrics", timeout=60))["data"]
    finally:
        server.shutdown()
        service.shutdown()
        server.server_close()
        thread.join(timeout=10)

    lat = [o[0] for o in out]
    samples_per_token = engine.cfg.flow.token_mel_ratio * engine.cfg.hift.upsample_scale
    each = [o[1] // samples_per_token for o in out]
    tokens = sum(each)
    rec = dict(mode=mode, requests=n, seed_base=seed_base, **_percentiles("latency_s", lat),
               **_percentiles("ms_per_token", [1e3 * t / max(k, 1) for t, k in zip(lat, each)]),
               wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
               audio_s_per_s=sum(o[1] for o in out) / sr / wall,
               latencies_s=lat, tokens_each=each, metrics=metrics)
    if before is not None:
        done = {k: service.batcher.stats[k] - before[k] for k in before}
        rec.update(batcher=done, ms_per_slot_step=1e3 * done["decode_s"] / max(done["steps"], 1))
    return rec


def main(argv=None):
    p = argparse.ArgumentParser("serve_load")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rates", default="0.5,1.0,1.5", help="requests per second, comma-separated")
    p.add_argument("--reps", type=int, default=4, help="runs of each mode at each rate")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-tokens", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0, help="seed of the arrival schedule")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_load needs a CUDA GPU")
    engine, frontend = launcher.build(launcher.parse_args(
        ["--device", "cuda", "--max-tokens", str(args.max_tokens)]))
    card = _card()
    runs = []
    for rate in (float(r) for r in args.rates.split(",")):
        gaps = np.random.default_rng(args.seed).exponential(1.0 / rate, args.requests)
        gaps[0] = 0.0
        for j in range(2 * args.reps):
            mode = ("window", "slots", "slots", "window")[j % 4]
            rec = dict(rate_rps=rate, card=card, **run_load(
                engine, frontend, mode, args.slots, gaps, seed_base=SEED_BASE * (1 + j // 4)))
            runs.append(rec)
            print(json.dumps({k: v for k, v in rec.items()
                              if k not in ("latencies_s", "tokens_each")}), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(dict(card=card, device=torch.cuda.get_device_name(0), args=vars(args),
                       runs=runs), f, indent=1)


if __name__ == "__main__":
    main()
