"""Where one full-width SFT synthesis spends its time on the card.

    python -m flowmirror_hydravox_tpu_torch.tools.profile_decode [--heads 2] [--max-tokens 200] \
        [--synth-overlap REPS] [--quantize int8]

Needs a CUDA GPU. Builds the engine as the server's launcher does (default
HydraVoxConfig(), random weights: LLM and flow bf16, HiFT f32), runs one warm-up
synthesis, then traces one synthesis under torch.profiler (CPU + CUDA). For
each engine stage span (`engine.llm`, `engine.synth`) it reports the host
wall time, the device busy time (the union of the kernels that start inside
the span) and the device's idle share, and for the LM the same per decode
step, and the kernel launches per decode step. It also lists the ops that
take the most host time, the kernels that take the most device time, each
hand-written kernel's device time and share of the LM stage (decode
attention; the fused MLP GEMV), and the host time of one call of each at its
serving shape. Device numbers are null when the profiler saw no device
activity.

`--quantize int8` traces the same synthesis (same weights, text and seed)
again on an engine built with `quantize="int8"` (ops/quant.py), beside the
dense one: for each, the LLM weight bytes a decode step reads, wall and
device-busy ms per step, the LM stage's idle share and launches per step
(under "int8"; the dense figures stay at the top level). It then times
four seeded requests on a 4-slot `ContinuousBatcher` at `--heads`, dense,
int8, int8, dense, in this process alone (no server): ms per slot step
(`int8.slot_steps`).

`--synth-overlap REPS` adds why the continuous batcher synthesises on its
decode thread, between chunks, where the JAX batcher has a synthesis thread:
per rep, four seeded one-sentence requests decode on a 4-slot
`ContinuousBatcher` at heads 2 twice, alone and while a second thread runs
`Engine.synthesize_tokens` (flow + HiFT of SYNTH_TOKENS tokens) in a loop.
It reports ms per slot step (the batcher's decode time over its steps) and
the time of one synthesis, alone and overlapped.

Prints one JSON line and writes it to chiprun_out/profile_decode.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time

import torch
from torch.autograd import DeviceType

from .. import __main__ as launcher
from ..ops.quant import tree_bytes
from ..ops.sampling import SamplingParams
from ..runtime.continuous import ContinuousBatcher
from ..runtime.engine import Engine, SynthesisResult

TEXT = "The quick brown fox jumps over the lazy dog and then keeps on running."
OUT = os.path.join("chiprun_out", "profile_decode.json")
KERNELS = {"decode_attention": ("decode_attn_kernel",),
           "mlp_gemv": ("swiglu_kernel", "down_kernel", "int8_mlp_kernel")}
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
STAGES = ("engine.llm", "engine.synth")
SLOT_TEXTS = ["The first caller asks for a short weather report.",
              "A second caller wants the opening hours of the library.",
              "The third request reads a line from a story for children.",
              "Here the fourth caller orders a taxi to the station."]
SYNTH_TOKENS = 100


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def analyse(prof, res: SynthesisResult, top: int = 15) -> dict:
    events = list(prof.events())
    # device-side activity, less the spans' own annotations on the device track
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA and e.name not in STAGES]
    stages = {}
    for name in STAGES:
        span = next(e for e in events if e.name == name and e.device_type == DeviceType.CPU)
        s0, s1 = span.time_range.start, span.time_range.end
        busy = _union_us([(s, e) for s, e in kernels if s0 <= s < s1]) if kernels else None
        stages[name] = {"wall_ms": (s1 - s0) / 1e3,
                        "device_busy_ms": None if busy is None else busy / 1e3,
                        "device_idle_share": None if busy is None else 1.0 - busy / (s1 - s0)}
    llm = stages["engine.llm"]
    span = next(e for e in events if e.name == "engine.llm" and e.device_type == DeviceType.CPU)
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.name in LAUNCH_CALLS
                   and span.time_range.start <= e.time_range.start < span.time_range.end)
    per_step = {"steps": res.steps, "tokens": len(res.speech_tokens),
                "wall_ms": llm["wall_ms"] / max(res.steps, 1),
                "device_busy_ms": (None if llm["device_busy_ms"] is None
                                   else llm["device_busy_ms"] / max(res.steps, 1)),
                "kernel_launches": launches / max(res.steps, 1)}

    avgs = prof.key_averages()
    host = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)[:top]
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA and a.key not in STAGES
                  and a.self_device_time_total > 0),
                 key=lambda a: a.self_device_time_total, reverse=True)
    kernel_us = {name: sum(a.self_device_time_total for a in dev
                           if any(k in a.key for k in names))
                 for name, names in KERNELS.items()}
    all_dev_us = sum(a.self_device_time_total for a in dev)
    return {
        "stages": stages,
        "llm_per_step": per_step,
        "host_top": [{"op": a.key, "calls": a.count, "self_cpu_ms": a.self_cpu_time_total / 1e3}
                     for a in host],
        "device_top": [{"kernel": a.key[:120], "calls": a.count,
                        "device_ms": a.self_device_time_total / 1e3} for a in dev[:top]],
        "device_total_ms": all_dev_us / 1e3 if dev else None,
        # both kernels run only in the LM stage
        **{f"{name}_device_ms": us / 1e3 if dev else None for name, us in kernel_us.items()},
        **{f"{name}_share_of_llm_device": (us / 1e3 / llm["device_busy_ms"]
                                           if llm["device_busy_ms"] else None)
           for name, us in kernel_us.items()},
    }


def weight_bytes_per_step(params: dict, heads: int, head_num: int) -> int:
    """LLM weight bytes a decode step at `heads` heads reads: the backbone's
    layers, the live leaves of `heads` MTP heads (their q/k projections are
    never multiplied) and the decoder, scales included."""
    mtp = sum(tree_bytes(v)[0] for k, v in params["mtp_block"].items()
              if not k.startswith(("q_proj", "k_proj")))
    decoder = sum(tree_bytes(v)[0] for k, v in params.items() if k.startswith("llm_decoder"))
    return tree_bytes(params["backbone"]["layers"])[0] + mtp * heads // head_num + decoder


def host_us(fn, n: int = 200) -> float:
    """Host time of one call, launches queued without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def wrapper_host_us() -> dict:
    """Each kernel's host cost per call at its serving shape, bf16: decode
    attention at B 1, T 2, S_max 512; the MLP at M 2, 896 x 4864."""
    from ..ops.attention import decode_attention_dispatch
    from ..ops.mlp_gemv import mlp_gemv

    q = torch.randn(1, 2, 14, 64, device="cuda").to(torch.bfloat16)
    k = torch.randn(1, 512, 2, 64, device="cuda").to(torch.bfloat16)
    v = torch.randn(1, 512, 2, 64, device="cuda").to(torch.bfloat16)
    cl = torch.tensor([255], dtype=torch.int32, device="cuda")
    x = torch.randn(2, 896, device="cuda").to(torch.bfloat16)
    gate, up = (torch.randn(896, 4864, device="cuda").to(torch.bfloat16) for _ in range(2))
    down = torch.randn(4864, 896, device="cuda").to(torch.bfloat16)
    return {"decode_attention": host_us(lambda: decode_attention_dispatch(q, k, v, cl)),
            "mlp_gemv": host_us(lambda: mlp_gemv(x, gate, up, down))}


def slot_run(engine, rows, heads: int = 2, side=None) -> dict:
    """Seeded requests `rows` (request i on seed i) on a 4-slot
    ContinuousBatcher at `heads`, with `side` (a thread) running meanwhile
    when given: the batcher's steps, the tokens and its ms per slot step."""
    batcher = ContinuousBatcher(engine, slots=4, head_num=heads,
                                sampling=SamplingParams.make(0.9, 10, 24, 0.2))
    if side is not None:
        side.start()
    try:
        reqs = [batcher.submit(r, noise=engine.noise_for(i)) for i, r in enumerate(rows)]
        outs = [batcher.result(r, timeout=600.0)[1] for r in reqs]
    finally:
        batcher.shutdown()
    st = batcher.stats
    return dict(steps=st["steps"], tokens=[len(o["tokens"]) for o in outs],
                ms_per_step=1e3 * st["decode_s"] / st["steps"])


def synth_overlap(engine, frontend, reps: int) -> dict:
    """The --synth-overlap experiment (module docstring)."""
    rows = [frontend.extract_text_tokens(t) for t in SLOT_TEXTS]
    tokens = torch.randint(0, engine.cfg.llm.speech_token_size, (engine.max_tokens,),
                           dtype=torch.int32, device=engine.device)

    def synth() -> float:
        t0 = time.perf_counter()
        engine.synthesize_tokens(tokens, SYNTH_TOKENS, engine.noise_for(0))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def decode(overlap: bool) -> dict:
        synth_ms, stop = [], threading.Event()

        def synth_loop():
            while not stop.is_set():
                synth_ms.append(synth())

        side = threading.Thread(target=synth_loop, daemon=True) if overlap else None
        try:
            run = slot_run(engine, rows, side=side)
        finally:
            stop.set()
            if side is not None:
                side.join(timeout=60)
        return dict(overlap=overlap, **run, synth_ms_overlapped=synth_ms)

    decode(False)  # warm-up
    synth_alone = [synth() for _ in range(3)]
    runs = [decode(overlap) for _ in range(reps) for overlap in (False, True)]
    return dict(synth_tokens=SYNTH_TOKENS, synth_ms_alone=synth_alone, runs=runs)


def slots_int8(engines: dict, frontend, heads: int) -> list:
    """ms per slot step of the dense and the int8 engine, alone in this
    process (no server), in the order dense, int8, int8, dense."""
    rows = [frontend.extract_text_tokens(t) for t in SLOT_TEXTS]
    for eng in engines.values():
        slot_run(eng, rows, heads)  # warm-up
    return [dict(mode=mode, **slot_run(engines[mode], rows, heads))
            for mode in ("dense", "int8", "int8", "dense")]


def main(argv=None):
    p = argparse.ArgumentParser("profile_decode")
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--max-tokens", type=int, default=200)
    p.add_argument("--synth-overlap", type=int, default=0, metavar="REPS")
    p.add_argument("--quantize", default=None, choices=["int8"])
    args = p.parse_args(argv)

    engine, frontend = launcher.build(launcher.parse_args(
        ["--device", "cuda", "--max-tokens", str(args.max_tokens)]))
    feats = frontend.frontend_sft(frontend.text_normalize(TEXT, split=False)[0], "default")

    def trace(eng) -> dict:
        def synth():
            res = eng.synthesize(feats["text_tokens"], feats["tts_text_len"],
                                 inference_head_num=args.heads,
                                 spk_embedding=feats["spk_embedding"], noise=eng.noise_for(0))
            torch.cuda.synchronize()
            return res

        synth()  # warm-up: first-use library set-up stays out of the trace
        t0 = time.time()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = synth()
        return {"traced_wall_s": time.time() - t0,
                "llm_time_s": res.llm_time, "synth_time_s": res.synth_time,
                "weight_bytes_per_step": weight_bytes_per_step(
                    eng.llm_params, args.heads, eng.cfg.llm.head_num),
                **analyse(prof, res)}

    report = {
        "card": _card(),
        "config": "HydraVoxConfig()",
        "heads": args.heads, "max_tokens": args.max_tokens,
        **trace(engine),
        "host_us_per_call": wrapper_host_us(),
    }
    if args.quantize == "int8":
        int8_engine = Engine(engine.cfg, engine.llm_params, engine.flow_params,
                             engine.hift_params, max_tokens=engine.max_tokens,
                             device=engine.device, quantize="int8")
        report["int8"] = trace(int8_engine)
        report["int8"]["slot_steps"] = slots_int8({"dense": engine, "int8": int8_engine},
                                                  frontend, args.heads)
    if args.synth_overlap:
        report["synth_overlap"] = synth_overlap(engine, frontend, args.synth_overlap)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
