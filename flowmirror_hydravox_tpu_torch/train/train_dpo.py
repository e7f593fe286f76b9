"""DPO training CLI for the MTP LLM on one device: port of
flowmirror_hydravox_tpu/train/train_dpo.py.

    python -m flowmirror_hydravox_tpu_torch.train.train_dpo \
        --train_data /path/to/hf_dataset --output_dir ckpts/dpo \
        --model_ckpt ckpts/llm/final.npz [--ref_ckpt ckpts/sft.npz] [--device cuda|cpu]

The reference's `bin/train.py --dpo true --ref_model ...` path
(bin/train.py:131-173, train_utils.py:238-274): the policy trains against a
frozen reference model; the loss is the preference loss (`--beta` 0.01,
`--label_smoothing`, `--ipo`) plus the SFT CE on the chosen sequence. Rows
need "text" (or "text_token"), "speech_token" (chosen) and
"reject_speech_token" (rejected), as the reference's dpo=True dataset
(dataset/processor.py:432-438).

The policy starts from `--model_ckpt` (a JAX-format npz or the reference's
llm.pt), else from `--seed`, in bf16. The reference model is `--ref_ckpt`,
else a copy of the policy's initial weights (the reference deep-copies the
model before training): separate tensors, since the update is in place, and
none of them requires a gradient. The JAX trainer's flags and defaults (lr
1e-5, warmup 100, batch 8, static batches), plus `--device` (default cuda),
`--resume` and `--grad_accum`; the multi-device flags are refused
(train/cli.py). `train` is the loop over any iterable of collated batches,
which chip_smoke.py drives from memory.
"""

from __future__ import annotations

import logging

import torch

from ..config import HydraVoxConfig, tiny_config
from ..params import flatten_params, init_llm_params, unflatten_params
from . import checkpoint as ckpt
from .cli import check_args, common_parser, load_weights, summary_writer, train_device
from .data import DPOCollator, make_batch_source
from .steps import OptimConfig, Optimizer, batch_to, dpo_train_step, init_state, train_loop

logger = logging.getLogger("hydravox.train_dpo")


def parse_args(argv=None):
    p = common_parser("train_dpo")
    p.set_defaults(learning_rate=1e-5, warmup_steps=100, max_steps=10_000, logging_steps=20,
                   save_steps=1000)
    p.add_argument("--ref_ckpt", default=None,
                   help="frozen reference model (default: a copy of the policy's initial "
                        "weights, bin/train.py:163-169)")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--beta", type=float, default=0.01, help="DPO beta (bin/train.py:166)")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--ipo", action="store_true", help="IPO objective variant")
    args = p.parse_args(argv)
    check_args(p, args)
    if args.batch_type != "static":
        p.error("--batch_type dynamic: DPO batches are static, as in the JAX trainer")
    return args


def frozen_copy(params: dict) -> dict:
    """A copy of `params` in tensors of its own that require no gradient."""
    return unflatten_params({k: v.detach().clone() for k, v in flatten_params(params).items()})


def log_line(step: int, m: dict, s_per_it: float) -> str:
    """JAX train_dpo.py:163-168's line."""
    return (f"step {step} loss {m['loss']:.4f} sft {m['sft_loss']:.4f} dpo {m['dpo_loss']:.4f} "
            f"dpo_acc {m['dpo_acc']:.3f} rewards {m['chosen_reward']:+.3f}/"
            f"{m['reject_reward']:+.3f} ({s_per_it:.2f} s/it)")


def train(args, cfg, params, ref_params, batches, on_step=None):
    """Train the policy `params` (the LLM tree on its device; trained in
    place) against `ref_params` over `batches` (collated numpy DPO dicts) as
    the flags in `args` say; `on_step(state, metrics)` runs after each
    step. Returns (state, the last metrics)."""
    device = ckpt.tree_device(params)
    optimizer = Optimizer(OptimConfig(learning_rate=args.learning_rate,
                                      warmup_steps=args.warmup_steps, total_steps=args.max_steps))
    state = init_state(params, optimizer)
    if args.resume:
        state = ckpt.restore_train_state(args.resume, state)
        logger.info("resumed at step %d", state.step)
    logger.info("beta=%g label_smoothing=%g ipo=%s", args.beta, args.label_smoothing, args.ipo)

    def step_fn(s, batch):
        return dpo_train_step(s, ref_params, batch_to(batch, device), cfg, optimizer,
                              beta=args.beta, label_smoothing=args.label_smoothing, ipo=args.ipo,
                              accum_steps=args.grad_accum)

    return train_loop(state, batches, step_fn, max_steps=args.max_steps,
                      output_dir=args.output_dir, logging_steps=args.logging_steps,
                      save_steps=args.save_steps, tb=summary_writer(args), on_step=on_step,
                      log=logger, log_line=log_line)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from ..frontend.tokenizer import get_tokenizer

    device = train_device(args)
    full_cfg = tiny_config() if args.tiny else HydraVoxConfig()
    cfg = full_cfg.llm
    params = init_llm_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device,
                             torch.bfloat16)
    if args.model_ckpt:
        params = load_weights(args.model_ckpt, "llm", full_cfg, params)
        logger.info("policy init from %s", args.model_ckpt)
    ref_params = frozen_copy(load_weights(args.ref_ckpt, "llm", full_cfg, params)
                             if args.ref_ckpt else params)

    batches, _ = make_batch_source(
        DPOCollator(get_tokenizer(args.tokenizer_path)), args.batch_size,
        train_data=args.train_data, shard_list=args.shard_list, seed=args.seed,
        epochs=args.epochs)
    state, metrics = train(args, cfg, params, ref_params, batches)
    return {"step": state.step, "metrics": metrics}


if __name__ == "__main__":
    main()
