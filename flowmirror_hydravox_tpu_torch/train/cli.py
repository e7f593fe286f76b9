"""Flags and set-up shared by the trainers (train_llm.py, train_flow.py,
train_dpo.py; train_hift.py takes `LATER_PARALLEL` and `train_device`).

The trainers keep the JAX trainers' flags. This port trains on one device
(`--device`, default cuda). The multi-device flags are refused with a
message that names the slice that ports them, never ignored.
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..convert import torch_import
from ..device import resolve_device
from ..params import cast_like
from .checkpoint import load_params_npz, tree_device

LATER_PARALLEL = ("multi-device training is not ported yet: it waits for the parallel/ "
                  "slice (torch DDP/FSDP, ROADMAP queue 1)")


def common_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog)
    p.add_argument("--train_data", default=None, help="HF dataset dir")
    p.add_argument("--shard_list", default=None,
                   help="parquet/dataset shard-list file (reference dataset/dataset.py:125 chain)")
    p.add_argument("--batch_type", choices=["static", "dynamic"], default="static")
    p.add_argument("--max_frames_in_batch", type=int, default=12000,
                   help="dynamic-batch token budget (processor.py:324)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_ckpt", default=None, help="weights-only npz or torch .pt")
    p.add_argument("--batch_size", type=int, default=8, help="global batch size")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=2500)
    p.add_argument("--max_steps", type=int, default=100_000)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="tiny config (tests)")
    p.add_argument("--tensorboard_dir", default=None,
                   help="write TB scalars (reference train_utils.py:187-192)")
    p.add_argument("--resume", default=None,
                   help="train-state dir (step_<n>.pt files this package wrote)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batch gradient accumulation (reference "
                        "train_utils.py:277-291): batch_size is the global batch; "
                        "backward runs on batch_size/grad_accum rows at a time")
    # the JAX trainers' multi-device flags: refused here (check_args)
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--shard_optimizer", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--multihost", action="store_true")
    return p


def check_args(parser: argparse.ArgumentParser, args):
    """Exit non-zero (argparse's error) for what this port does not run."""
    for flag, on in (("--tensor_parallel", args.tensor_parallel > 1),
                     ("--pipeline_parallel", getattr(args, "pipeline_parallel", 1) > 1),
                     ("--pp_microbatches", getattr(args, "pp_microbatches", 0) > 0),
                     ("--fsdp", args.fsdp), ("--shard_optimizer", args.shard_optimizer),
                     ("--multihost", args.multihost)):
        if on:
            parser.error(f"{flag}: {LATER_PARALLEL}")
    if not (args.train_data or args.shard_list):
        parser.error("--train_data or --shard_list required")
    if args.grad_accum > 1:
        if args.batch_type != "static":
            parser.error("--grad_accum needs static batches")
        if args.batch_size % args.grad_accum:
            parser.error(f"batch_size {args.batch_size} not divisible by "
                         f"grad_accum {args.grad_accum}")


def train_device(args) -> torch.device:
    """The trainer's `--device` (device.resolve_device), named in the log
    (logger `hydravox.train`), so a job's log shows where it ran."""
    device = resolve_device(args.device)
    logging.getLogger("hydravox.train").info("training on device %s", device)
    return device


def load_weights(path: str, name: str, cfg, params):
    """`params` (model `name` of the HydraVoxConfig `cfg`) replaced by the
    weights of `path` (a JAX-format npz, else the reference's .pt through
    convert/torch_import.py), cast like `params`."""
    if path.endswith(".npz"):
        return load_params_npz(path, params)
    tree = torch_import.convert(name, torch_import.load_torch_pt(path), cfg)
    return cast_like(tree, params, tree_device(params))


def summary_writer(args):
    """A tensorboardX writer when --tensorboard_dir is given (imported only
    then, as in the JAX trainers), else None."""
    if not args.tensorboard_dir:
        return None
    from tensorboardX import SummaryWriter

    return SummaryWriter(args.tensorboard_dir)
