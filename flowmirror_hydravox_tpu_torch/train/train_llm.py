"""LLM (MTP) training CLI on one device: port of
flowmirror_hydravox_tpu/train/train_llm.py.

    python -m flowmirror_hydravox_tpu_torch.train.train_llm \
        --train_data /path/to/hf_dataset --output_dir ckpts/llm \
        --batch_size 8 --learning_rate 1e-4 --max_steps 10000 [--device cuda|cpu]

The JAX trainer's flags and loop: bf16 weights from `--seed` (or
`--model_ckpt`, a JAX-format npz or the reference's llm.pt), AdamW with the
warmup-cosine schedule over `--max_steps`, logging every
`--logging_steps`, the train state saved every `--save_steps` and at the
end, eval loss on `--auto_val_split` every `--eval_steps`, `--resume`,
`--grad_accum`, `--batch_type dynamic`, `--phoneme_aug` (phoneme-substitution
text augmentation, train/phoneme_aug.py, seeded by `--seed`). The train
state is this package's (`train/checkpoint.py`: torch.save, not orbax), so
a JAX run cannot resume here nor the other way round; weights cross as npz.
Runs on the card unless `--device cpu`; the JAX multi-device flags are
refused (train/cli.py).

`main` parses the flags and opens the data; `train` is the loop over any
iterable of collated batches, which chip_smoke.py drives from memory.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import HydraVoxConfig, tiny_config
from ..models import llm as llm_model
from ..params import init_llm_params
from . import checkpoint as ckpt
from .cli import check_args, common_parser, load_weights, summary_writer, train_device
from .data import LLMCollator, batch_iterator, make_batch_source
from .steps import OptimConfig, Optimizer, batch_to, init_state, llm_train_step, train_loop

logger = logging.getLogger("hydravox.train_llm")


def parse_args(argv=None):
    p = common_parser("train_llm")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--auto_val_split", action="store_true")
    p.add_argument("--val_split_ratio", type=float, default=0.05)
    p.add_argument("--phoneme_aug", action="store_true",
                   help="phoneme-substitution text augmentation (reference "
                        "train_speech_model.py:550-565)")
    # refused (train/cli.py check_args), as the other multi-device flags
    p.add_argument("--pipeline_parallel", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    args = p.parse_args(argv)
    check_args(p, args)
    return args


def train(args, cfg, params, batches, val_ds=None, collator=None, on_step=None):
    """Train `params` (the LLM tree on its device; trained in place) over
    `batches` (collated numpy dicts) as the flags in `args` say. `val_ds`
    and `collator` give the eval loss; `on_step(state, metrics)` runs after
    each step. Returns (state, the last metrics)."""
    device = ckpt.tree_device(params)
    optimizer = Optimizer(OptimConfig(learning_rate=args.learning_rate,
                                      warmup_steps=args.warmup_steps, total_steps=args.max_steps))
    state = init_state(params, optimizer)
    if args.resume:
        state = ckpt.restore_train_state(args.resume, state)
        logger.info("resumed at step %d", state.step)

    def step_fn(s, batch):
        return llm_train_step(s, batch_to(batch, device), cfg, optimizer,
                              accum_steps=args.grad_accum)

    eval_fn = None
    if val_ds is not None:
        @torch.no_grad()
        def eval_fn(s):
            losses = [float(llm_model.forward_loss(
                s.params, cfg, *(batch_to(vb, device)[k] for k in (
                    "text_token", "text_len", "speech_token", "speech_len")))["loss"])
                for vb in batch_iterator(val_ds, collator, args.batch_size, shuffle=False,
                                         epochs=1)]
            return float(np.mean(losses))

    return train_loop(state, batches, step_fn, max_steps=args.max_steps,
                      output_dir=args.output_dir, logging_steps=args.logging_steps,
                      save_steps=args.save_steps, eval_fn=eval_fn, eval_steps=args.eval_steps,
                      tb=summary_writer(args), on_step=on_step, log=logger)


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
        logger.info("loaded weights from %s", args.model_ckpt)

    aug = None
    if args.phoneme_aug:
        from ..frontend.tokenizer import SPECIAL_TOKENS
        from .phoneme_aug import PhonemeAugmenter

        aug = PhonemeAugmenter(SPECIAL_TOKENS, seed=args.seed)
    collator = LLMCollator(get_tokenizer(args.tokenizer_path), phoneme_aug=aug)
    batches, val_ds = make_batch_source(
        collator, args.batch_size, train_data=args.train_data, shard_list=args.shard_list,
        batch_type=args.batch_type, max_frames_in_batch=args.max_frames_in_batch,
        seed=args.seed, epochs=args.epochs,
        val_split=args.val_split_ratio if args.auto_val_split else 0.0)
    state, metrics = train(args, cfg, params, batches, val_ds, collator)
    return {"step": state.step, "metrics": metrics}


if __name__ == "__main__":
    main()
