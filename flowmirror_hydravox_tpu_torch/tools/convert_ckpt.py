"""Checkpoint conversion and post-processing CLI: port of
flowmirror_hydravox_tpu/tools/convert_ckpt.py (reference post-process
tooling, SURVEY §2.9).

  - import: a torch .pt or .safetensors state dict -> the JAX npz format
    (convert_checkpoint_bin_to_pt.py / convert_safetensor_to_pt.py), through
    convert/torch_import.py's converters;
  - average: the f32 mean of npz checkpoints (bin/average_model.py),
    train/checkpoint.py `average_checkpoints`;
  - graft-mtp: fresh MTP heads on a single-head LLM
    (add_mtp_weights_to_cosyvoice3lm_ckpt.py), train/checkpoint.py
    `graft_mtp_weights`. The heads are drawn from a `torch.Generator`
    seeded with `--seed`, so they are not the JAX package's draws; every
    other leaf is the source's, bit for bit.

Templates come from params.py's initialisers (f32, on the CPU).
`.safetensors` is read without the `safetensors` package: an 8-byte
little-endian header length, a JSON header, then the raw buffers (BF16
through torch).

Usage:
  python -m flowmirror_hydravox_tpu_torch.tools.convert_ckpt import \
      --model llm --src llm.pt --dst llm.npz [--tiny]
  python -m flowmirror_hydravox_tpu_torch.tools.convert_ckpt average \
      --inputs a.npz b.npz c.npz --dst avg.npz --model llm
  python -m flowmirror_hydravox_tpu_torch.tools.convert_ckpt graft-mtp \
      --src single_head.npz --dst multi_head.npz [--seed 1986]
"""

from __future__ import annotations

import argparse
import json
import logging
import struct

import numpy as np
import torch

logger = logging.getLogger("hydravox.convert_ckpt")

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> dict:
    """A .safetensors file as {name: f32 numpy array}."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}, not read here")
        lo, hi = meta["data_offsets"]
        t = torch.frombuffer(bytearray(data[lo:hi]), dtype=_SAFETENSORS_DTYPES[meta["dtype"]]) \
            if hi > lo else torch.empty(0, dtype=_SAFETENSORS_DTYPES[meta["dtype"]])
        out[name] = t.reshape(meta["shape"]).to(torch.float32).numpy()
    return out


def _load_state_dict(path: str) -> dict:
    from ..convert.torch_import import load_torch_pt

    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_torch_pt(path)


def _strip_prefixes(sd: dict) -> dict:
    """Strip HF-Trainer wrapper prefixes (convert_checkpoint_bin_to_pt.py:77:
    'core_model.' / 'module.' / epoch-step bookkeeping keys)."""
    out = {}
    for k, v in sd.items():
        for prefix in ("core_model.", "module.", "model_wrapper."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k in ("epoch", "step"):
            continue
        out[k] = v
    return out


def _config(tiny: bool):
    from ..config import HydraVoxConfig, tiny_config

    return tiny_config() if tiny else HydraVoxConfig()


def _template(model: str, tiny: bool):
    """(an f32 tree of `model` on the CPU from seed 0, the full config)."""
    from ..params import init_flow_params, init_hift_params, init_llm_params

    cfg = _config(tiny)
    init = {"llm": init_llm_params, "flow": init_flow_params, "hift": init_hift_params}[model]
    return init(getattr(cfg, model), torch.Generator().manual_seed(0), "cpu", torch.float32), cfg


def cmd_import(args):
    from ..convert import torch_import
    from ..params import flatten_params

    sd = _strip_prefixes(_load_state_dict(args.src))
    params = torch_import.convert(args.model, sd, _config(args.tiny))
    np.savez(args.dst, **flatten_params(params))
    logger.info("wrote %s", args.dst)


def cmd_average(args):
    from ..train.checkpoint import average_checkpoints, save_params_npz

    template, _ = _template(args.model, args.tiny)
    save_params_npz(args.dst, average_checkpoints(args.inputs, template))
    logger.info("averaged %d checkpoints -> %s", len(args.inputs), args.dst)


def cmd_graft_mtp(args):
    from ..train.checkpoint import graft_mtp_weights, load_params_npz, save_params_npz

    template, cfg = _template("llm", args.tiny)
    params = load_params_npz(args.src, template)
    grafted = graft_mtp_weights(params, cfg.llm, torch.Generator().manual_seed(args.seed))
    save_params_npz(args.dst, grafted)
    logger.info("grafted fresh MTP heads (seed %d) -> %s", args.seed, args.dst)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("convert_ckpt")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("import")
    pi.add_argument("--model", choices=["llm", "flow", "hift"], required=True)
    pi.add_argument("--src", required=True)
    pi.add_argument("--dst", required=True)
    pi.add_argument("--tiny", action="store_true")
    pi.set_defaults(fn=cmd_import)

    pa = sub.add_parser("average")
    pa.add_argument("--model", choices=["llm", "flow", "hift"], required=True)
    pa.add_argument("--inputs", nargs="+", required=True)
    pa.add_argument("--dst", required=True)
    pa.add_argument("--tiny", action="store_true")
    pa.set_defaults(fn=cmd_average)

    pg = sub.add_parser("graft-mtp")
    pg.add_argument("--src", required=True)
    pg.add_argument("--dst", required=True)
    pg.add_argument("--seed", type=int, default=1986)
    pg.add_argument("--tiny", action="store_true")
    pg.set_defaults(fn=cmd_graft_mtp)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
