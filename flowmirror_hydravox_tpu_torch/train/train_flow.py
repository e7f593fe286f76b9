"""Flow (CFM) training CLI on one device: port of
flowmirror_hydravox_tpu/train/train_flow.py.

    python -m flowmirror_hydravox_tpu_torch.train.train_flow \
        --train_data /path/to/hf_dataset --output_dir ckpts/flow \
        --batch_size 8 --max_steps 10000 [--device cuda|cpu]

The structure of train_llm.py with the CFM objective: bf16 weights (the
`rand_noise` buffer f32), rows with "speech_token", "mel" (or "audio",
whose 24 kHz mel is computed here) and "embedding". Each step's CFM draws
(t, noise, condition and dropout masks) come from a `torch.Generator`
seeded with `--seed` on the training device: the JAX trainer's draws come
from its key chain, which torch cannot replay.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import HydraVoxConfig, tiny_config
from ..noise import TorchNoise
from ..params import init_flow_params
from ..utils import audio as audio_utils
from . import checkpoint as ckpt
from .cli import check_args, common_parser, load_weights, summary_writer, train_device
from .data import FlowCollator, make_batch_source
from .steps import OptimConfig, Optimizer, batch_to, flow_train_step, init_state, train_loop

logger = logging.getLogger("hydravox.train_flow")


def parse_args(argv=None):
    p = common_parser("train_flow")
    args = p.parse_args(argv)
    check_args(p, args)
    return args


def train(args, cfg, params, batches, on_step=None):
    """Train `params` (the flow tree on its device; trained in place) over
    `batches` (collated numpy dicts) as the flags in `args` say;
    `on_step(state, metrics)` runs after each step. Returns (state, the
    last metrics)."""
    device = ckpt.tree_device(params)
    optimizer = Optimizer(OptimConfig(learning_rate=args.learning_rate,
                                      warmup_steps=args.warmup_steps, total_steps=args.max_steps))
    state = init_state(params, optimizer)
    if args.resume:
        state = ckpt.restore_train_state(args.resume, state)
        logger.info("resumed at step %d", state.step)
    noise = TorchNoise(torch.Generator(device=device).manual_seed(args.seed))

    def step_fn(s, batch):
        return flow_train_step(s, batch_to(batch, device), noise, cfg, optimizer,
                               accum_steps=args.grad_accum)

    return train_loop(state, batches, step_fn, max_steps=args.max_steps,
                      output_dir=args.output_dir, logging_steps=args.logging_steps,
                      save_steps=args.save_steps, tb=summary_writer(args), on_step=on_step,
                      log=logger)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = train_device(args)
    full_cfg = tiny_config() if args.tiny else HydraVoxConfig()
    cfg, m = full_cfg.flow, full_cfg.mel
    params = init_flow_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                              device, torch.bfloat16)
    if args.model_ckpt:
        params = load_weights(args.model_ckpt, "flow", full_cfg, params)
        logger.info("loaded weights from %s", args.model_ckpt)

    def mel_extract(wav, sr):
        wav24 = audio_utils.resample_linear(torch.as_tensor(wav, dtype=torch.float32)[None],
                                            sr, m.sample_rate)
        mel = audio_utils.mel_spectrogram(wav24, m.n_fft, m.num_mels, m.sample_rate,
                                          m.hop_size, m.win_size, m.fmin, m.fmax)
        return np.asarray(mel[0].T)

    collator = FlowCollator(mel_extract_fn=mel_extract, token_mel_ratio=cfg.token_mel_ratio)
    batches, _ = make_batch_source(
        collator, args.batch_size, train_data=args.train_data, shard_list=args.shard_list,
        batch_type=args.batch_type, max_frames_in_batch=args.max_frames_in_batch,
        seed=args.seed, epochs=args.epochs)
    state, metrics = train(args, cfg, params, batches)
    return {"step": state.step, "metrics": metrics}


if __name__ == "__main__":
    main()
