"""Checkpoint I/O and post-processing: port of
flowmirror_hydravox_tpu/train/checkpoint.py.

  - Weights cross between the packages in the JAX package's flat npz format
    (`save_params_npz` / `load_params_npz`: dot-joined keys, bf16 stored as
    f32): an npz written here loads in the JAX package and in the port's
    `Engine`, and the other way round.
  - Train states do not cross: the JAX package saves them with orbax, which
    the port does not use. `save_train_state` writes `torch.save` of
    {params, opt_state, step} (the port's `train.steps.TrainState`) to
    `<path>/step_<n>.pt`; `restore_train_state` reads the newest one back
    onto a template state's devices and dtypes.
  - `average_checkpoints` (reference bin/average_model.py) and
    `graft_mtp_weights` (add_mtp_weights_to_cosyvoice3lm_ckpt.py), whose
    fresh heads come from a `torch.Generator`: only the copied leaves can
    equal the JAX package's.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np
import torch

from ..params import cast_like, flatten_params, init_llm_params, unflatten_params
from .steps import TrainState, tree_leaves


def save_train_state(path: str, state: TrainState):
    """Write `state` to `<path>/step_<state.step>.pt`."""
    os.makedirs(path, exist_ok=True)
    torch.save({"params": {k: p.detach() for k, p in tree_leaves(state.params)},
                "opt_state": state.opt_state, "step": state.step},
               os.path.join(path, f"step_{state.step}.pt"))


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """The newest state saved in `path`, each tensor on the device and at
    the dtype of the template's leaf it replaces; the template's tensors are
    overwritten in place, so the restored state trains the same tensors."""
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.fullmatch(r"step_(\d+)\.pt", f))]
    if not steps:
        raise FileNotFoundError(f"no step_<n>.pt train state in {path}")
    saved = torch.load(os.path.join(path, f"step_{max(steps)}.pt"), map_location="cpu",
                       weights_only=True)
    with torch.no_grad():
        for k, p in tree_leaves(template.params):
            p.copy_(saved["params"][k])
    opt = template.opt_state
    for name in ("mu", "nu"):
        for k, t in opt[name].items():
            t.copy_(saved["opt_state"][name][k])
    opt["count"] = int(saved["opt_state"]["count"])
    return TrainState(params=template.params, opt_state=opt, step=int(saved["step"]))


def tree_device(tree) -> torch.device:
    return next(iter(flatten_params(tree).values())).device


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    # np.savez cannot store bf16: the JAX format keeps it as f32
    return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()


def save_params_npz(path: str, params, dtype=None):
    """`params` in the JAX flat npz format; every leaf cast to the numpy
    `dtype` when one is given (np.float16 for the committed extractors)."""
    np.savez(path, **{k: _to_numpy(v) if dtype is None else _to_numpy(v).astype(dtype)
                      for k, v in flatten_params(params).items()})


def load_params_npz(path: str, template):
    """The npz at `path` as a tree shaped like `template`, each leaf at the
    dtype and on the device of the template's leaf (the file may hold more
    keys; a missing one raises KeyError)."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    flat = flatten_params(template)
    missing = set(flat) - set(data)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    return cast_like(unflatten_params({k: data[k] for k in flat}), template, tree_device(template))


def average_checkpoints(paths: List[str], template):
    """The mean of N weights-only npz checkpoints, in f32, cast like
    `template` (choosing the N is the caller's job, as in the reference)."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        with np.load(p) as f:
            flat = {k: f[k].astype(np.float32) for k in flatten_params(template)}
        acc = flat if acc is None else {k: acc[k] + v for k, v in flat.items()}
    n = np.float32(len(paths))
    avg = {k: v / n for k, v in acc.items()}
    return cast_like(unflatten_params(avg), template, tree_device(template))


def graft_mtp_weights(single_head_params: dict, cfg, generator: torch.Generator,
                      dtype=torch.bfloat16) -> dict:
    """`single_head_params` (an LLM tree without, or with stale, `mtp_block`)
    with freshly initialized MTP heads, so that multi-head training can start
    from single-head weights."""
    out = dict(single_head_params)
    out["mtp_block"] = init_llm_params(cfg, generator, tree_device(single_head_params),
                                       dtype)["mtp_block"]
    return out
