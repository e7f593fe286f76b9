"""Train steps for the LLM (MTP multi-head CE, and DPO against a frozen
reference model) and the flow (CFM MSE) on one device: port of
flowmirror_hydravox_tpu/train/steps.py.

The JAX package's optimizer is `optax.chain(clip_by_global_norm(clip),
adamw(schedule, b1, b2, weight_decay))`. optax is JAX-only, so `Optimizer`
writes that chain out over the parameter tree, in optax's order and dtypes:

  - the global norm is the square root of the sum of each leaf's sum of
    squares, leaves in JAX's order (dict keys sorted), in the leaves' dtype;
    gradients above `grad_clip` are scaled by clip / norm (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`);
  - Adam's moments keep the parameter dtype (optax's `mu_dtype=None`), bias
    correction uses count + 1, and the decoupled weight decay applies to
    every leaf (the flow's `rand_noise` buffer too, whose gradient the flow
    step zeroes: the buffer still shrinks by 1 - lr * wd a step);
  - the learning rate is the schedule at the optimizer's own count;
  - a Python float meeting a bf16 leaf is rounded to bf16 first, as JAX
    rounds a weak-typed constant (b2 = 0.999 becomes 1.0 against bf16
    moments).

A non-finite gradient norm skips the update (train_utils.py:305-315):
`TrainState.step` advances, the parameters, the moments and the
optimizer's count do not. The step reads that one flag on the host.

The update is in place: a step changes the tensors of the state it is given
and returns that state. Gradients come from `torch.autograd.grad`; a leaf
that the loss does not reach gets a zero gradient. Under gradient
accumulation the micro-batch gradients are summed in f32, averaged and cast
back to the parameter dtype (JAX `_value_and_grad_accum`).

Under torch.profiler each micro-batch's forward and backward appear as a
`train.loss_grad` range and the update as `train.optimizer`
(`tools/bench_train.trace_summary` splits a traced step by them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import FlowConfig, LLMConfig
from ..models import flow as flow_model
from ..models import llm as llm_model


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 2500
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    schedule: str = "warmup_cosine"  # warmup_cosine, constant, warmuplr, noam, noamhold
    total_steps: int = 200_000


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate at an optimizer count, in f32 as optax computes it
    (reference cosyvoice/utils/scheduler.py): warmup_cosine (optax's
    warmup_cosine_decay_schedule from 0), constant, warmuplr (WarmupLR),
    noam / noamhold (NoamHoldAnnealing, hold 10% of total_steps after the
    warmup, decay 0.5)."""
    f32 = np.float32
    lr = f32(cfg.learning_rate)
    # short runs (smoke trainings) keep a valid warmup
    warmup = max(min(cfg.warmup_steps, cfg.total_steps // 2), 1)
    w = f32(warmup)

    if cfg.schedule == "warmup_cosine":
        decay_steps = f32(max(cfg.total_steps, warmup + 1) - warmup)

        def warmup_cosine(count: int) -> float:
            if count < warmup:
                frac = f32(1) - f32(count) / w
                return float(-lr * frac + lr)
            c = min(f32(count - warmup), decay_steps)
            return float(lr * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / decay_steps))))

        return warmup_cosine
    if cfg.schedule == "constant":
        return lambda count: float(lr)
    if cfg.schedule == "warmuplr":
        def warmuplr(count: int) -> float:
            s = max(f32(count), f32(1))
            return float(lr * w ** f32(0.5) * min(s ** f32(-0.5), s * w ** f32(-1.5)))

        return warmuplr
    if cfg.schedule in ("noam", "noamhold"):
        hold = f32(0.1 * cfg.total_steps) if cfg.schedule == "noamhold" else f32(0)
        anneal_start = w + hold

        def noam(count: int) -> float:
            s = max(f32(count), f32(1))
            if s <= w:
                return float(lr * s / w)
            if s <= anneal_start:
                return float(lr)
            return float(lr * (max(s, anneal_start) / anneal_start) ** f32(-0.5))

        return noam
    raise ValueError(f"unknown schedule {cfg.schedule}")


def as_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as JAX rounds a Python float that meets an
    array of that dtype."""
    return torch.tensor(value, dtype=dtype).item()


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dot-joined path, leaf) pairs in JAX's leaf order: dict keys sorted,
    lists by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_leaves(v, f"{prefix}{i}."))
        return out
    return [(prefix[:-1], tree)]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: each leaf's sum of squares in its dtype, summed in
    leaf order, then the square root."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Optimizer:
    """clip_by_global_norm(grad_clip) then AdamW, as optax chains them (see
    the module docstring). State: {"count": updates applied, "mu": {path:
    tensor}, "nu": {path: tensor}}, moments in each leaf's dtype."""

    eps = 1e-8

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in leaves},
                "nu": {k: torch.zeros_like(p) for k, p in leaves}}

    @torch.no_grad()
    def apply(self, params, grads: Dict[str, torch.Tensor], opt_state: dict) -> torch.Tensor:
        """Update `params` and `opt_state` in place from `grads` ({path: grad},
        the parameter dtypes); skip the update when the gradient norm is not
        finite. Returns the gradient norm."""
        cfg = self.cfg
        leaves = tree_leaves(params)
        g_list = [grads[k] for k, _ in leaves]
        gnorm = global_norm(g_list)
        finite, clip = torch.stack([torch.isfinite(gnorm), gnorm >= cfg.grad_clip]).tolist()
        if not finite:
            return gnorm
        count = opt_state["count"] + 1  # Adam's bias correction counts this update
        lr = self.schedule(opt_state["count"])
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(count))
        for (k, p), g in zip(leaves, g_list):
            dt = p.dtype
            if clip:
                g = (g / gnorm.to(dt)) * as_dtype(cfg.grad_clip, dt)
            mu, nu = opt_state["mu"][k], opt_state["nu"][k]
            mu.mul_(as_dtype(cfg.b1, dt)).add_(g * as_dtype(1 - cfg.b1, dt))
            nu.mul_(as_dtype(cfg.b2, dt)).add_((g * g) * as_dtype(1 - cfg.b2, dt))
            update = (mu / as_dtype(bc1, dt)) / (
                torch.sqrt(nu / as_dtype(bc2, dt)) + as_dtype(self.eps, dt))
            update = update + p * as_dtype(cfg.weight_decay, dt)
            p.add_(update * as_dtype(-lr, dt))
        opt_state["count"] = count
        return gnorm


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int


def init_state(params, optimizer: Optimizer) -> TrainState:
    """A state at step 0 over `params`, whose floating leaves are set to
    require gradients (the tensors themselves: the state trains them)."""
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _grads(loss, leaves) -> List[torch.Tensor]:
    got = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for (_, p), g in zip(leaves, got)]


def _aux_map(fn, aux, *more):
    """`fn` over an aux value: None, a tensor, or a dict of tensors (with
    `more` of the same structure)."""
    if aux is None:
        return None
    if isinstance(aux, dict):
        return {k: fn(v, *(m[k] for m in more)) for k, v in aux.items()}
    return fn(aux, *more)


def _value_and_grad_accum(loss_fn, params, batch: dict, accum_steps: int, noise=None):
    """(loss, aux, grads {path: grad}) of `loss_fn(params, batch[, noise])`
    -> (loss, aux), aux None, a tensor or a dict of tensors. With
    accum_steps k > 1 the batch's rows split into k equal micro-batches
    (k, B // k) in order, each with its own noise source (`noise.split(k)`);
    gradients, loss and each aux value are summed in f32 and averaged,
    gradients cast back to the parameter dtypes."""
    leaves = tree_leaves(params)

    def one(mb, nz):
        with torch.enable_grad(), torch.profiler.record_function("train.loss_grad"):
            loss, aux = loss_fn(params, mb) if nz is None else loss_fn(params, mb, nz)
            return loss.detach(), _aux_map(torch.Tensor.detach, aux), _grads(loss, leaves)

    if accum_steps <= 1:
        loss, aux, grads = one(batch, noise)
        return loss, aux, {k: g for (k, _), g in zip(leaves, grads)}

    k = int(accum_steps)
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch dim {x.shape[0]} of {name} not divisible by "
                             f"accum_steps {k}")
    noises = [None] * k if noise is None else noise.split(k)
    gsum = [torch.zeros_like(p, dtype=torch.float32) for _, p in leaves]
    lsum, asum = 0.0, None
    for i in range(k):
        mb = {n: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i] for n, x in batch.items()}
        loss, aux, grads = one(mb, noises[i])
        for acc, g in zip(gsum, grads):
            acc.add_(g.to(torch.float32))
        lsum = lsum + loss.to(torch.float32)
        aux32 = _aux_map(lambda a: a.to(torch.float32), aux)
        asum = aux32 if asum is None else _aux_map(torch.add, asum, aux32)
    grads = {n: (g / k).to(p.dtype) for (n, p), g in zip(leaves, gsum)}
    return lsum / k, _aux_map(lambda a: a / k, asum), grads


def _apply(state: TrainState, grads: dict, optimizer: Optimizer) -> torch.Tensor:
    with torch.profiler.record_function("train.optimizer"):
        gnorm = optimizer.apply(state.params, grads, state.opt_state)
    state.step += 1
    return gnorm


def loss_train_step(state: TrainState, batch: dict, loss_fn: Callable,
                    optimizer: Optimizer) -> Tuple[TrainState, dict]:
    """One optimizer update of any model: `loss_fn(params, batch) -> (loss,
    {name: metric})` (the frontend, VAD and ASR trainers). Returns (state,
    {"loss", each metric, "grad_norm"})."""
    loss, aux, grads = _value_and_grad_accum(loss_fn, state.params, batch, 1)
    gnorm = _apply(state, grads, optimizer)
    return state, {"loss": loss, **aux, "grad_norm": gnorm}


def llm_train_step(state: TrainState, batch: dict, cfg: LLMConfig, optimizer: Optimizer,
                   accum_steps: int = 1) -> Tuple[TrainState, dict]:
    """One optimizer update of the MTP LM. batch: text_token (B, Lt),
    text_len (B,), speech_token (B, Ls), speech_len (B,) tensors on the
    parameters' device. Returns (state, {"loss", "acc", "grad_norm"})."""

    def loss_fn(params, mb):
        out = llm_model.forward_loss(params, cfg, mb["text_token"], mb["text_len"],
                                     mb["speech_token"], mb["speech_len"])
        return out["loss"], out["acc"]

    loss, acc, grads = _value_and_grad_accum(loss_fn, state.params, batch, accum_steps)
    gnorm = _apply(state, grads, optimizer)
    return state, {"loss": loss, "acc": acc, "grad_norm": gnorm}


DPO_KEYS = ("text_token", "text_len", "chosen_token", "chosen_len", "rejected_token",
            "rejected_len")


def dpo_train_step(state: TrainState, ref_params: dict, batch: dict, cfg: LLMConfig,
                   optimizer: Optimizer, beta: float = 0.01, label_smoothing: float = 0.0,
                   ipo: bool = False, accum_steps: int = 1) -> Tuple[TrainState, dict]:
    """One DPO update of the policy in `state` (JAX steps.py:206-257,
    reference bin/train.py:162-173): the preference loss against the frozen
    `ref_params` plus the SFT CE on the chosen rows. The reference model's
    log-probabilities are computed per micro-batch without a gradient.
    batch: `DPO_KEYS` tensors on the parameters' device. Returns (state,
    {"loss", "grad_norm", "sft_loss", "dpo_loss", "acc", "dpo_acc",
    "chosen_reward", "reject_reward"})."""
    from ..models.llm_extras import dpo_loss, forward_dpo

    def loss_fn(params, mb):
        args = [mb[k] for k in DPO_KEYS]
        with torch.no_grad():
            ref = forward_dpo(ref_params, cfg, *args)
        out = forward_dpo(params, cfg, *args)
        pref, chosen_r, rejected_r = dpo_loss(
            out["chosen_logps"], out["rejected_logps"], ref["chosen_logps"],
            ref["rejected_logps"], beta=beta, label_smoothing=label_smoothing, ipo=ipo)
        aux = {"sft_loss": out["loss"], "dpo_loss": pref, "acc": out["acc"],
               "dpo_acc": (chosen_r > rejected_r).to(torch.float32).mean(),
               "chosen_reward": chosen_r.mean(), "reject_reward": rejected_r.mean()}
        return pref + out["loss"], aux

    loss, aux, grads = _value_and_grad_accum(loss_fn, state.params, batch, accum_steps)
    gnorm = _apply(state, grads, optimizer)
    return state, {"loss": loss, "grad_norm": gnorm, **aux}


def flow_train_step(state: TrainState, batch: dict, noise, cfg: FlowConfig,
                    optimizer: Optimizer, accum_steps: int = 1) -> Tuple[TrainState, dict]:
    """One optimizer update of the flow. batch: speech_token (B, Lt),
    token_len, speech_feat (B, Tm, 80), feat_len, embedding (B, 192); `noise`
    gives the CFM draws (noise.py `flow_loss`), split per micro-batch under
    accumulation. `rand_noise` is a fixed buffer: its gradient is zeroed."""

    def loss_fn(params, mb, nz):
        loss = flow_model.compute_loss(params, cfg, nz, mb["speech_token"], mb["token_len"],
                                       mb["speech_feat"], mb["feat_len"], mb["embedding"])
        return loss, None

    loss, _, grads = _value_and_grad_accum(loss_fn, state.params, batch, accum_steps, noise)
    grads["rand_noise"] = torch.zeros_like(grads["rand_noise"])
    gnorm = _apply(state, grads, optimizer)
    return state, {"loss": loss, "grad_norm": gnorm}


def batch_to(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def matmul_params(tree) -> int:
    """The count of parameters in leaves of two or more dimensions, the
    count 6 x params x tokens takes (JAX tools/bench_train.py)."""
    return sum(p.numel() for _, p in tree_leaves(tree) if p.dim() >= 2)


def train_loop(state: TrainState, batches, step_fn, *, max_steps: int, output_dir: str,
               logging_steps: int = 50, save_steps: int = 2000, eval_fn=None,
               eval_steps: int = 1000, tb=None, on_step: Optional[Callable] = None,
               log=None, log_line: Optional[Callable] = None) -> Tuple[TrainState, dict]:
    """The trainers' loop (JAX train_llm.py:245-283, train_flow.py:173-196,
    train_dpo.py:155-180): `step_fn(state, batch) -> (state, metrics)` over
    `batches` until `max_steps`; logs every `logging_steps` (and to `tb`, a
    SummaryWriter), saves the train state every `save_steps` and at the end,
    logs `eval_fn(state)` every `eval_steps`. `log_line(step, metrics as
    floats, seconds per step)` formats the log line (default: every metric
    by name). `on_step(state, metrics)` runs after each step. Returns
    (state, the last step's metrics as floats)."""
    from . import checkpoint  # here: checkpoint imports this module

    t0 = time_ref = time.time()
    metrics = {}
    for batch in batches:
        state, metrics = step_fn(state, batch)
        if on_step is not None:
            on_step(state, metrics)
        step = state.step
        if step % logging_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            s_per_it = (time.time() - time_ref) / max(logging_steps, 1)
            if log is not None and log_line is not None:
                log.info("%s", log_line(step, m, s_per_it))
            elif log is not None:
                log.info("step %d %s (%.2f s/it)", step,
                         " ".join(f"{k} {v:.5g}" for k, v in m.items()), s_per_it)
            if tb is not None:
                for k, v in m.items():
                    tb.add_scalar(f"train/{k}", v, step)
            time_ref = time.time()
        if step % save_steps == 0 and step > 0:
            checkpoint.save_train_state(output_dir, state)
        if eval_fn is not None and step % eval_steps == 0 and step > 0:
            loss = eval_fn(state)
            if log is not None:
                log.info("eval step %d loss %.4f", step, loss)
        if step >= max_steps:
            break
    checkpoint.save_train_state(output_dir, state)
    if log is not None:
        log.info("done at step %d in %.1f s", state.step, time.time() - t0)
    return state, {k: float(v) for k, v in metrics.items()}
