"""Train-step benchmark on the card: port of
flowmirror_hydravox_tpu/tools/bench_train.py.

    python -m flowmirror_hydravox_tpu_torch.tools.bench_train --which llm|flow|dpo|gan \
        [--steps 10] [--accum K] [--peak_tflops 989] [--device cuda|cpu] [--tiny] \
        [--profile 3]

Shapes (the JAX benchmark's): LLM B 16, Lt 64, Ls 256, plus one longer
point, B 8, Ls 512; flow B 16, Lt 128 (256 mel frames); DPO B 4 pairs, Lt
64, Ls 256, the reference model a copy of the policy, lr 1e-5; GAN B 4 x 32
mel frames (15,360 samples), the full HiFT and discriminators at f32, lr
2e-4. `--accum K` (LLM only) runs the first LLM point at a global batch of
16 x K, the backward on micro-batches of 16 (`train_step_llm_accum{K}`).
Full-size `HydraVoxConfig()` weights (bf16; f32 for the GAN) from a seeded
init, `llm_train_step` / `flow_train_step` / `dpo_train_step` /
`gan_train_step`. Each point prints one JSON
line: ms per step (the median of `--steps` steps after two warm-up steps,
each ended by `torch.cuda.synchronize()`), tokens (mel frames for the flow)
per second (and pairs per second for DPO), MFU as 6 x matmul params x
tokens over `--peak_tflops` (989: the H100 SXM's dense bf16 peak; the flow
count leaves out attention, as the JAX benchmark's does; DPO counts the
policy's forward and backward over chosen and rejected and the reference
model's forward over both, (6 x 2 + 2 x 2) x every matmul leaf x B x (2 +
Lt + Ls), as JAX's does), peak memory (`torch.cuda.max_memory_allocated`),
and the card's name and power limit. The GAN point has no MFU (its work is
convolutions and FFTs, as in the JAX benchmark): it prints audio seconds
per second, the first step's generator loss, the generator and
discriminator halves' ms (CUDA events around each half, on the card), and
the cuDNN settings it ran under (PyTorch's defaults run f32 convs in
TF32).
`--profile N` adds where a step's
time goes: N steps under torch.profiler (per step: wall, device busy, the
device's idle share, kernel launches, host synchronisations, the kernels
with the most device time, the host and device ms of train/steps.py's
`train.loss_grad` and `train.optimizer` ranges) and the optimizer's update alone (median of 5
synced calls on one step's gradients; both optimizers for the GAN). Runs on the card unless
`--device cpu` (a smoke run: no device metric is printed there).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

def card_census() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_steps(step, n_steps: int, device) -> list:
    """Seconds of each of `n_steps` calls of `step()` after two warm-up calls,
    each ended by a device synchronisation."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = []
    for i in range(n_steps + 2):
        t0 = time.perf_counter()
        step()
        sync()
        if i >= 2:
            out.append(time.perf_counter() - t0)
    return out


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
STEP_RANGES = ("train.loss_grad", "train.optimizer")  # train/steps.py's record_function names


def trace_summary(prof, wall_s: float, n_steps: int, top: int = 10, ranges=()) -> dict:
    """Per-step figures of `n_steps` steps that `prof` traced over `wall_s`
    seconds: wall, device busy (the union of kernel and copy intervals),
    device work (their sum) and the device's idle share, kernel launches,
    host synchronisations, the kernels with the most device time, and for
    each `torch.profiler.record_function` name in `ranges` its host ms and
    the device ms of the work whose op started while it was open, on any
    thread (the backward's ops run on autograd's own thread). Device figures
    are None when the profiler saw no device activity."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    # a record_function range also shows on the device's timeline, spanning
    # its kernels and the gaps between them: not device work
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    annotations.update(STEP_RANGES, ranges)
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA and e.name not in annotations]
    busy_ms = _union_us(kernels) / 1e3 / n_steps if kernels else None
    dev = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CUDA
                  and a.key not in annotations and a.self_device_time_total > 0),
                 key=lambda a: a.self_device_time_total, reverse=True)
    wall_ms = wall_s * 1e3 / n_steps
    work_ms = sum(b - a for a, b in kernels) / 1e3 / n_steps if kernels else None
    out = {"steps": n_steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_work_ms": work_ms,
           "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
           "launches": sum(e.name in LAUNCH_CALLS for e in host) / n_steps,
           "host_syncs": sum(e.name in SYNC_CALLS for e in host) / n_steps,
           "device_top": [{"kernel": a.key[:100], "calls": a.count / n_steps,
                           "device_ms": a.self_device_time_total / 1e3 / n_steps}
                          for a in dev[:top]]}
    # a kernel or copy shares its id (CUPTI's correlation id) with the runtime
    # call that started it: (that call's start, the work's duration)
    called_at = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    starts = [(called_at[e.id], e.time_range.end - e.time_range.start) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in annotations
              and e.id in called_at]
    if kernels:  # the device work so placed, against device_work_ms
        out["device_linked_ms"] = sum(us for _, us in starts) / 1e3 / n_steps
    for name in ranges:
        spans = [(e.time_range.start, e.time_range.end) for e in host if e.name == name]
        dev_us = sum(us for t, us in starts if any(a <= t <= b for a, b in spans))
        out[name] = {"host_ms": sum(b - a for a, b in spans) / 1e3 / n_steps,
                     "device_ms": dev_us / 1e3 / n_steps if kernels else None}
    return out


def profile(step, n_steps: int, optimizer_apply, top: int = 10) -> dict:
    """`n_steps` calls of `step()` under torch.profiler, then
    `optimizer_apply()` timed alone. Per-step figures (`trace_summary`)."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = trace_summary(prof, wall, n_steps, top, ranges=STEP_RANGES)
    out["optimizer_ms"] = statistics.median(time_steps(optimizer_apply, 5,
                                                       torch.device("cuda"))) * 1e3
    return out


def report(name, secs, tokens, matmul_params, peak_tflops, device, flops_per=6,
           **extra) -> dict:
    """A point's line; MFU counts `flops_per` x matmul params x tokens."""
    step_s = statistics.median(secs)
    out = {"metric": name, "device": str(device), "step_ms": step_s * 1e3,
           "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3,
           "tokens_per_s": tokens / step_s, "tokens": tokens, "matmul_params": matmul_params,
           **extra}
    if device.type == "cuda":
        out["mfu"] = flops_per * matmul_params * tokens / step_s / (peak_tflops * 1e12)
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        out["card"] = card_census()
    return out


def bench_llm(cfg, device, b, lt, ls, n_steps, peak_tflops, n_profile=0, seed=0,
              accum=1) -> dict:
    from ..models import llm as llm_model
    from ..params import init_llm_params
    from ..train.steps import (OptimConfig, Optimizer, _value_and_grad_accum, batch_to,
                               init_state, llm_train_step, matmul_params)

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_llm_params(cfg, gen, device, torch.bfloat16)
    p_mm = sum(matmul_params(params[k]) for k in ("mtp_block", "llm_decoder")) + matmul_params(
        params["backbone"]["layers"])
    opt = Optimizer(OptimConfig(warmup_steps=10, total_steps=1000))
    state = init_state(params, opt)
    rng = np.random.default_rng(seed)
    batch = batch_to({
        "text_token": np.zeros((b, lt), np.int32),
        "text_len": np.full((b,), lt, np.int32),
        "speech_token": rng.integers(0, cfg.speech_token_size, (b, ls)).astype(np.int32),
        "speech_len": np.full((b,), ls, np.int32)}, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    secs = time_steps(lambda: llm_train_step(state, batch, cfg, opt, accum_steps=accum),
                      n_steps, device)
    name = f"train_step_llm_b{b}_ls{ls}" if accum == 1 else f"train_step_llm_accum{accum}"
    out = report(name, secs, b * (2 + lt + ls), p_mm, peak_tflops, device, batch=[b, lt, ls],
                 grad_accum=accum)
    if n_profile:
        def loss_fn(p, mb):
            res = llm_model.forward_loss(p, cfg, *(mb[k] for k in (
                "text_token", "text_len", "speech_token", "speech_len")))
            return res["loss"], res["acc"]

        grads = _value_and_grad_accum(loss_fn, state.params, batch, accum)[2]
        out["profile"] = profile(lambda: llm_train_step(state, batch, cfg, opt,
                                                        accum_steps=accum), n_profile,
                                 lambda: opt.apply(state.params, grads, state.opt_state))
    return out


def bench_flow(cfg, device, b, lt, n_steps, peak_tflops, n_profile=0, seed=0) -> dict:
    from ..models import flow as flow_model
    from ..noise import TorchNoise
    from ..params import init_flow_params
    from ..train.steps import (OptimConfig, Optimizer, _value_and_grad_accum, batch_to,
                               flow_train_step, init_state, matmul_params)

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_flow_params(cfg, gen, device, torch.bfloat16)
    p_mm = matmul_params(params)
    opt = Optimizer(OptimConfig(warmup_steps=10, total_steps=1000))
    state = init_state(params, opt)
    tm = lt * cfg.token_mel_ratio
    rng = np.random.default_rng(seed)
    batch = batch_to({
        "speech_token": rng.integers(0, min(1000, cfg.vocab_size), (b, lt)).astype(np.int32),
        "token_len": np.full((b,), lt, np.int32),
        "speech_feat": (rng.standard_normal((b, tm, 80)) - 4.0).astype(np.float32),
        "feat_len": np.full((b,), tm, np.int32),
        "embedding": rng.standard_normal((b, 192)).astype(np.float32)}, device)
    noise = TorchNoise(gen)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    secs = time_steps(lambda: flow_train_step(state, batch, noise, cfg, opt), n_steps, device)
    out = report("train_step_flow", secs, b * tm, p_mm, peak_tflops, device, batch=[b, lt, tm])
    if n_profile:
        def loss_fn(p, mb, nz):
            return flow_model.compute_loss(p, cfg, nz, *(mb[k] for k in (
                "speech_token", "token_len", "speech_feat", "feat_len", "embedding"))), None

        grads = _value_and_grad_accum(loss_fn, state.params, batch, 1, noise)[2]
        out["profile"] = profile(lambda: flow_train_step(state, batch, noise, cfg, opt),
                                 n_profile, lambda: opt.apply(state.params, grads,
                                                              state.opt_state))
    return out


def bench_dpo(cfg, device, b, lt, ls, n_steps, peak_tflops, seed=0) -> dict:
    from ..params import init_llm_params
    from ..train.steps import (OptimConfig, Optimizer, batch_to, dpo_train_step, init_state,
                               matmul_params)
    from ..train.train_dpo import frozen_copy

    params = init_llm_params(cfg, torch.Generator(device=device).manual_seed(seed), device,
                             torch.bfloat16)
    ref_params = frozen_copy(params)
    opt = Optimizer(OptimConfig(learning_rate=1e-5, warmup_steps=10, total_steps=1000))
    state = init_state(params, opt)
    rng = np.random.default_rng(seed)
    batch = batch_to({
        "text_token": np.zeros((b, lt), np.int32),
        "text_len": np.full((b,), lt, np.int32),
        "chosen_token": rng.integers(0, cfg.speech_token_size, (b, ls)).astype(np.int32),
        "chosen_len": np.full((b,), ls, np.int32),
        "rejected_token": rng.integers(0, cfg.speech_token_size, (b, ls)).astype(np.int32),
        "rejected_len": np.full((b,), ls, np.int32)}, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    secs = time_steps(lambda: dpo_train_step(state, ref_params, batch, cfg, opt), n_steps, device)
    return report("train_step_dpo", secs, b * (2 + lt + ls), matmul_params(params), peak_tflops,
                  device, flops_per=6 * 2 + 2 * 2, pairs_per_s=b / statistics.median(secs),
                  batch=[b, lt, ls])


def bench_gan(cfg, device, b, frames, n_steps, n_profile=0, seed=0) -> dict:
    """JAX bench_gan's point: B `b` x `frames` mel frames, its seeded batch,
    lr 2e-4 with 10 warm-up steps of 1000."""
    from ..noise import TorchNoise
    from ..params import init_disc_params, init_hift_params
    from ..train import gan
    from ..train.steps import OptimConfig, Optimizer, _value_and_grad_accum, batch_to, init_state

    hcfg = cfg.hift
    t_audio = frames * hcfg.upsample_scale
    gen = torch.Generator(device=device).manual_seed(seed)
    optim = OptimConfig(learning_rate=2e-4, warmup_steps=10, total_steps=1000)
    gen_opt, disc_opt = Optimizer(optim), Optimizer(optim)
    gen_state = init_state(init_hift_params(hcfg, gen, device, torch.float32), gen_opt)
    disc_state = init_state(init_disc_params(gen, device, torch.float32), disc_opt)
    rng = np.random.default_rng(seed)
    batch = batch_to({
        "speech_feat": (rng.standard_normal((b, frames, 80)) - 4.0).astype(np.float32),
        "pitch_feat": (np.abs(rng.standard_normal((b, frames))) * 200.0).astype(np.float32),
        "speech": (rng.standard_normal((b, t_audio)) * 0.1).astype(np.float32)}, device)
    noise = TorchNoise(gen)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    halves = {"gen": [], "disc": []}
    loss0 = []

    def step(timed=True):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if on_card else []
        t = [time.perf_counter()]
        if on_card:
            marks[0].record()
        _, fake, gm = gan.gan_gen_step(gen_state, disc_state.params, batch, noise, hcfg, gen_opt)
        if on_card:
            marks[1].record()
        t.append(time.perf_counter())
        gan.gan_disc_step(disc_state, batch["speech"], fake, disc_opt)
        if on_card:
            marks[2].record()
        t.append(time.perf_counter())
        if timed:
            if on_card:
                marks[2].synchronize()
                ms = [marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])]
            else:
                ms = [(t[1] - t[0]) * 1e3, (t[2] - t[1]) * 1e3]
            halves["gen"].append(ms[0])
            halves["disc"].append(ms[1])
        if not loss0:  # the first (warm-up) step's
            loss0.append(float(gm["gen_loss"]))

    secs = time_steps(step, n_steps, device)
    step_s = statistics.median(secs)
    n_timed = slice(-n_steps, None)  # time_steps' two warm-up calls are timed here too
    out = {"metric": "train_step_gan", "device": str(device), "step_ms": step_s * 1e3,
           "step_ms_min": min(secs) * 1e3, "step_ms_max": max(secs) * 1e3,
           "gen_ms": statistics.median(halves["gen"][n_timed]),
           "disc_ms": statistics.median(halves["disc"][n_timed]),
           "audio_sec_per_sec": b * t_audio / cfg.mel.sample_rate / step_s,
           "gen_loss0": loss0[0], "batch": [b, frames, t_audio]}
    if on_card:
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        out["card"] = card_census()
        # f32 convs: cuDNN runs them in TF32 unless the caller turned it off
        out["cudnn"] = {"allow_tf32": torch.backends.cudnn.allow_tf32,
                        "deterministic": torch.backends.cudnn.deterministic}
    if n_profile:
        g_grads = _value_and_grad_accum(gan.gen_loss_fn(disc_state.params, hcfg),
                                        gen_state.params, batch, 1, noise)[2]
        # the update's time does not depend on the values: the real audio
        # stands in for the fake
        d_grads = _value_and_grad_accum(gan.disc_loss_fn, disc_state.params,
                                        {"real": batch["speech"], "fake": batch["speech"]},
                                        1)[2]

        def apply_both():
            gen_opt.apply(gen_state.params, g_grads, gen_state.opt_state)
            disc_opt.apply(disc_state.params, d_grads, disc_state.opt_state)

        out["profile"] = profile(lambda: step(timed=False), n_profile, apply_both)
    return out


def main(argv=None):
    p = argparse.ArgumentParser("bench_train")
    p.add_argument("--which", required=True, choices=["llm", "flow", "gan", "dpo"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation (llm only): global batch 16 x accum, the "
                        "backward on micro-batches of 16")
    p.add_argument("--peak_tflops", type=float, default=989.0,
                   help="dense bf16 peak of the card (H100 SXM: 989)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tiny", action="store_true", help="tiny config at small shapes (smoke run)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N more steps (card only): device busy and idle share, "
                        "launches, top kernels, the optimizer's share")
    args = p.parse_args(argv)
    if args.accum != 1 and args.which != "llm":
        p.error("--accum is implemented for --which llm only")
    if args.profile and args.which == "dpo":
        p.error("--profile traces the llm, flow and gan points")

    from ..config import HydraVoxConfig, tiny_config
    from ..device import resolve_device

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        p.error("--profile traces the card: it needs --device cuda")
    cfg = tiny_config() if args.tiny else HydraVoxConfig()
    if args.which == "llm" and args.accum > 1:
        b, lt, ls = (2, 8, 16) if args.tiny else (16, 64, 256)
        out = [bench_llm(cfg.llm, device, b * args.accum, lt, ls, args.steps, args.peak_tflops,
                         args.profile, accum=args.accum)]
    elif args.which == "llm":
        points = [(2, 8, 16)] if args.tiny else [(16, 64, 256), (8, 64, 512)]
        out = [bench_llm(cfg.llm, device, b, lt, ls, args.steps, args.peak_tflops, args.profile)
               for b, lt, ls in points]
    elif args.which == "dpo":
        b, lt, ls = (2, 8, 16) if args.tiny else (4, 64, 256)
        out = [bench_dpo(cfg.llm, device, b, lt, ls, args.steps, args.peak_tflops)]
    elif args.which == "gan":
        b, frames = (1, 8) if args.tiny else (4, 32)
        out = [bench_gan(cfg, device, b, frames, args.steps, args.profile)]
    else:
        b, lt = (2, 8) if args.tiny else (16, 128)
        out = [bench_flow(cfg.flow, device, b, lt, args.steps, args.peak_tflops, args.profile)]
    for line in out:
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
