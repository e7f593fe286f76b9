"""Serving under load: the seven scenarios of
flowmirror_hydravox_tpu/tools/bench_serving.py on the port's server.

    python -m flowmirror_hydravox_tpu_torch.tools.bench_serving [--budget 1500] \
        [--window 10] [--device cuda|cpu] [--tiny] [--scenarios NAME,...]

Builds the engine as the launcher does (default HydraVoxConfig(), random
weights from seed 0: LLM and flow bf16, HiFT f32; max_tokens 1024; `--tiny`
for the tiny config) with three random speakers spk0-spk2, and drives it
through tools/loadgen.py. Each line of stdout is one JSON object; the
metric lines come in this order (JAX's):

  host_dispatch_rtt_ms             a one-element op on the serving device and
                                   its .item(), the least of 10
  ttft_under_load_http_continuous  stream TTFT on 4 continuous decode slots
                                   while 6 closed-loop /tts workers load them
  staggered_load_continuous        Poisson open loop at 3 rps on the slots
  staggered_capacity_continuous    8 rps, meant to saturate the slots
  ttft_under_load_http             stream TTFT on a window-coalescing server
                                   under the same 6 workers
  staggered_load_window            3 rps on the window server
  staggered_mode_winner            the mode with the lower staggered p95
  service_throughput_8way          8 concurrent /tts through one TTSService

One server per mode serves every scenario of that mode, slots first; each
is warmed by one request before its first scenario (the JAX tool's prewarm
barriers only pay for XLA compiles). Every request carries heads 4. A
global deadline (`--budget`) is checked between scenarios: a scenario that
does not fit is skipped with a note, one that raises prints its error, and
the exit code stays 0. `--scenarios` runs a subset, named by their metric
lines (the TTFT lines, say, at a window long enough for ~20 streams each);
staggered_mode_winner comes with both staggered_load lines. The last
line counts each hand-written kernel's launches in the process. Runs on
the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np
import torch

from .. import __main__ as launcher
from ..device import resolve_device
from ..frontend.frontend import Frontend, SpeakerInfo
from ..frontend.tokenizer import get_tokenizer
from ..ops import decode_attention, mlp_gemv
from ..runtime.engine import Engine
from ..runtime.server import TTSService, make_server
from .loadgen import _tts_once, run_load

HEADS = 4
LG_TEXT = "流式播报延迟测试：新闻播报的语速通常是每分钟两百四十字左右。"
BURST_TEXT = "并发请求吞吐测试第%d句，新闻播报的速度通常是每分钟两百四十字左右。"
BG_WORKERS = 6  # closed-loop /tts workers under the TTFT scenarios
SCENARIOS = ("ttft_under_load_http_continuous", "staggered_load_continuous",
             "staggered_capacity_continuous", "ttft_under_load_http", "staggered_load_window",
             "service_throughput_8way")  # the metric lines --scenarios picks from


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(tiny: bool = False, device="cuda", max_tokens: int = 1024):
    """(engine, frontend) as the launcher builds them, with the speakers
    spk0-spk2 (seeded random embeddings, JAX :103-106) in place of
    `default`."""
    device = torch.device(device)
    tokenizer = get_tokenizer(None)
    cfg, trees = launcher.load_models(tiny, None, tokenizer, device)
    engine = Engine(cfg, trees["llm"], trees["flow"], trees["hift"], max_tokens=max_tokens,
                    device=device)
    frontend = Frontend(cfg, tokenizer=tokenizer, device=device)
    for i in range(3):
        frontend.add_speaker(f"spk{i}", SpeakerInfo(
            embedding=np.random.default_rng(i).standard_normal(192).astype(np.float32)))
    return engine, frontend


def dispatch_rtt_ms(device) -> float:
    """The least of 10 round trips of a one-element op on `device` and its
    .item(), in ms (after one untimed)."""
    x = torch.zeros((), device=device)
    (x + 1).item()
    rtts = []
    for i in range(10):
        t0 = time.perf_counter()
        (x + i).item()
        rtts.append(time.perf_counter() - t0)
    return min(rtts) * 1000


def run(args, engine, frontend, emit=emit) -> list:
    """The scenarios (module docstring) on `engine` and `frontend`, each
    line through `emit`; returns the lines."""
    t_start = time.time()
    lines = []
    chosen = set(args.scenarios.split(","))
    if chosen - set(SCENARIOS):
        raise ValueError(f"unknown scenarios {sorted(chosen - set(SCENARIOS))}")

    def out(obj):
        lines.append(obj)
        emit(obj)

    def remaining():
        return args.budget - (time.time() - t_start)

    rtt_ms = dispatch_rtt_ms(engine.device)
    out({"aux": True, "metric": "host_dispatch_rtt_ms", "value": rtt_ms,
         "note": "a one-element op on the serving device and its .item() (launch, "
                 "synchronise, copy back); a streamed chunk pays one such wait at least"})

    sr = engine.cfg.sample_rate
    pay = json.dumps({"text": LG_TEXT, "speaker_id": "spk0",
                      "extra_params": {"inference_head_num": HEADS}}).encode()

    def section(name, budget_need, fn):
        if remaining() < budget_need:
            out({"aux": True, "metric": name, "skipped": True,
                 "note": f"global budget exhausted ({remaining():.0f}s left, "
                         f"need ~{budget_need:.0f}s)"})
            return None
        t0 = time.time()
        try:
            res = fn()
        except Exception as e:  # reported as the scenario's line; the rest still run
            out({"aux": True, "metric": name, "error": f"{type(e).__name__}: {e}"[:300]})
            return None
        out({"aux": True, "section": name, "elapsed_s": round(time.time() - t0, 1)})
        return res

    # --- burst throughput: 8 concurrent /tts through one worker; run last --
    def throughput_8way():
        service = TTSService(engine, frontend, request_timeout=300.0, batch_window=0.05)
        try:
            texts = [BURST_TEXT % i for i in range(8)]

            def one_task(i):
                return {"type": "tts", "text": texts[i], "speaker_id": f"spk{i % 3}",
                        "extra_params": {"inference_head_num": HEADS}}

            service.wait(service.submit(one_task(0)))  # warm the worker

            def fire_all():
                outs = [None] * 8

                def one(i):
                    outs[i] = service.wait(service.submit(one_task(i)))

                threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
                t0 = time.time()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                return time.time() - t0, outs

            fire_all()  # as JAX: one untimed burst, then the best of two
            wall, outs = min((fire_all() for _ in range(2)), key=lambda x: x[0])
            n_err = sum(1 for o in outs if not (o and "output_audio" in o))
            audio_s = sum(len(o["output_audio"]) / sr for o in outs
                          if o and "output_audio" in o)
            out({
                "aux": True, "metric": "service_throughput_8way",
                "wall_s": round(wall, 3), "audio_s": round(audio_s, 2),
                "rtf_effective": round(wall / max(audio_s, 1e-9), 5),
                "errors": n_err,
                "batched_requests": service.batched_requests,
            })
        finally:
            service.shutdown()

    # --- one server per mode, reused by every scenario of that mode --------
    servers = {}

    def get_server(slots):
        if slots in servers:
            return servers[slots][1]
        srv = make_server("127.0.0.1", 0, engine, frontend, continuous_slots=slots,
                          continuous_head_num=HEADS, request_timeout=120.0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        servers[slots] = (srv, url, srv.RequestHandlerClass.service)
        _tts_once(url, pay, 300.0)  # warm-up: the first request on this server
        return url

    def shutdown_servers():
        for srv, _url, service in servers.values():
            srv.shutdown()
            service.shutdown()
            srv.server_close()

    def ttft_under_load(url):
        stop_flag = threading.Event()

        def bg():
            while not stop_flag.is_set():
                try:
                    _tts_once(url, pay, 120.0)
                except Exception:  # the background load's errors are not measured
                    pass

        bgs = [threading.Thread(target=bg, daemon=True) for _ in range(BG_WORKERS)]
        for t in bgs:
            t.start()
        time.sleep(1.0)  # let the background load reach steady state
        try:
            return run_load(url, pay, mode="stream", concurrency=2, duration=args.window,
                            warmup=1, timeout=120)
        finally:
            stop_flag.set()
            # the next scenario starts once the background's last requests are
            # answered (JAX leaves them running into it)
            for t in bgs:
                t.join(timeout=130)

    try:
        res_c = "ttft_under_load_http_continuous" in chosen and section(
            "ttft_under_load_continuous", 180, lambda: ttft_under_load(get_server(4)))
        if res_c:
            out({
                "aux": True, "metric": "ttft_under_load_http_continuous",
                "ttft_p50_ms": res_c["ttft_p50_ms"], "ttft_p95_ms": res_c["ttft_p95_ms"],
                "interchunk_gap_p95_ms": res_c["interchunk_gap_p95_ms"],
                "stream_requests": res_c["requests"], "errors": res_c["errors"],
                "bg_load": "6 closed-loop /tts workers on the same 4 slots "
                           "(1 reserved for streams)",
                "host_dispatch_rtt_ms": rtt_ms,
                "note": "a stream's first chunk is decoded in its admission burst and "
                        "synthesised on the slots' decode thread, ahead of whole "
                        "utterances, before the next slot step",
                "target_ms": 200,
            })

        # --- staggered (Poisson open loop) arrivals: window vs continuous --
        def staggered(url):
            res = run_load(url, pay, mode="tts", arrival="poisson", rate=3.0, concurrency=8,
                           duration=max(args.window, 15.0), warmup=1, timeout=120)
            try:
                with urllib.request.urlopen(f"{url}/api/v1/metrics", timeout=10) as r:
                    m = json.load(r).get("data") or {}
                # slots report admission; the window worker reports queue wait
                for q in ("p50", "p95"):
                    res[f"admission_ms_{q}"] = (m.get(f"admission_ms_{q}")
                                                if m.get(f"admission_ms_{q}") is not None
                                                else m.get(f"queue_wait_ms_{q}"))
            except OSError:  # the line then has no admission figures
                pass
            return res

        modes = {}

        def run_staggered(label, slots):
            if f"staggered_load_{label}" not in chosen:
                return
            r_m = section(f"staggered_load_{label}", 90, lambda: staggered(get_server(slots)))
            if not r_m:
                return
            modes[label] = r_m
            out({
                "aux": True, "metric": f"staggered_load_{label}",
                "rate_rps": 3.0, "requests": r_m["requests"], "errors": r_m["errors"],
                "latency_p50_ms": r_m["latency_p50_ms"],
                "latency_p95_ms": r_m["latency_p95_ms"],
                "rtf_effective": r_m["rtf_effective"],
                "admission_ms_p50": r_m.get("admission_ms_p50"),
                "admission_ms_p95": r_m.get("admission_ms_p95"),
                "note": "open loop: rtf_effective = wall/sum(audio) is "
                        "arrival-bound at this rate (floor = 1/(rate*mean_audio)); "
                        "tail latency + admission are the capacity signals",
            })

        # --- capacity probe: arrivals fast enough to bind on compute -------
        def capacity(url):
            return run_load(url, pay, mode="tts", arrival="poisson", rate=8.0, concurrency=16,
                            duration=max(args.window, 15.0), warmup=1, timeout=120)

        run_staggered("continuous", 4)
        r_cap = "staggered_capacity_continuous" in chosen and section(
            "staggered_capacity_continuous", 90, lambda: capacity(get_server(4)))
        if r_cap:
            out({
                "aux": True, "metric": "staggered_capacity_continuous",
                "rate_rps": 8.0, "requests": r_cap["requests"], "errors": r_cap["errors"],
                "latency_p50_ms": r_cap["latency_p50_ms"],
                "latency_p95_ms": r_cap["latency_p95_ms"],
                "rtf_effective": r_cap["rtf_effective"],
            })

        res_w = "ttft_under_load_http" in chosen and section(
            "ttft_under_load_window", 150, lambda: ttft_under_load(get_server(0)))
        if res_w:
            out({
                "aux": True, "metric": "ttft_under_load_http",
                "ttft_p50_ms": res_w["ttft_p50_ms"], "ttft_p95_ms": res_w["ttft_p95_ms"],
                "interchunk_gap_p95_ms": res_w["interchunk_gap_p95_ms"],
                "stream_requests": res_w["requests"], "errors": res_w["errors"],
                "bg_load": "6 closed-loop /tts workers", "target_ms": 200,
            })
        run_staggered("window", 0)

        if len(modes) == 2:
            better = min(modes, key=lambda k: modes[k]["latency_p95_ms"] or 1e18)
            note = ("fixed decode slots bound the tail: an admitted request does not wait "
                    "for a coalescing window" if better == "continuous" else
                    "window coalescing decodes a group as one flash batch, while the slots "
                    "synthesise each finished row alone on their decode thread")
            out({
                "aux": True, "metric": "staggered_mode_winner", "winner": better,
                "p95_window_ms": modes["window"]["latency_p95_ms"],
                "p95_continuous_ms": modes["continuous"]["latency_p95_ms"],
                "note": note,
            })
    finally:
        shutdown_servers()

    if "service_throughput_8way" in chosen:
        section("service_throughput_8way", 70, throughput_8way)
    out({"aux": True, "section": "bench_serving_total",
         "elapsed_s": round(time.time() - t_start, 1)})
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser("bench_serving")
    p.add_argument("--budget", type=float, default=1500.0,
                   help="global wall-clock budget (s); scenarios that don't "
                        "fit are skipped with a note")
    p.add_argument("--window", type=float, default=10.0,
                   help="load-measurement window per scenario (s)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke)")
    p.add_argument("--scenarios", default=",".join(SCENARIOS),
                   help="comma-separated metric names of the scenarios to run (default: all)")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # as the launcher: seeded requests repeat their PCM only with these
    torch.backends.cudnn.deterministic = True
    engine, frontend = build(args.tiny, device)
    lines = run(args, engine, frontend)
    # the hand-written kernels' launches in this process, for a caller that
    # runs the bench as a subprocess and so cannot read the ops' counters
    launches = {"aux": True, "section": "kernel_launches",
                "decode_attention": decode_attention.launch_count,
                "mlp_gemv": mlp_gemv.launch_count, "mlp_gemv_int8": mlp_gemv.int8_launch_count}
    emit(launches)
    return lines + [launches]


if __name__ == "__main__":
    main()
