"""Server launcher (port of flowmirror_hydravox_tpu/__main__.py, its serving
subset).

  python -m flowmirror_hydravox_tpu_torch --api-port 8080 [--with-ui] \
      [--tiny] [--model-dir DIR] [--max-tokens N] [--device cuda|cpu] \
      [--spk2info FILE] [--continuous-batching SLOTS] [--continuous-heads K] \
      [--continuous-reserve N] [--spec-decode] [--quantize none|bf16|int8]

--model-dir holds each model as `{name}.npz` in the JAX package's flat npz
format or as the reference's `{name}.pt` (llm.pt / flow.pt / hift.pt,
CosyVoice-3 key layout, weight-norm pairs folded; convert/torch_import.py);
the npz is preferred when both are there (JAX __main__.py:28-46). A missing
model means random weights from seed 0 (structure and latency testing).
With random full-width LLM weights the text vocab follows the tokenizer's,
padded to a multiple of 128; with llm.pt it is the checkpoint's. Serving
dtypes: bf16 for the LLM and flow, f32 for HiFT; the frontend's extractors
(the committed speech tokenizer and speaker encoder) f32, on the same
device.

--with-ui serves the web UI (runtime/webui.py) at GET / (JAX :53, :170).

--spk2info loads a speaker registry: a `.npz` as `Frontend.save_spk2info`
writes it (embeddings, prompt tokens and mels), anything else as the
reference's `spk2info.pt` (embeddings). A path that does not exist is an
error. A `default` speaker (zero embedding) is registered only when the
registry is empty (JAX __main__.py:160-165).

Batching, as the JAX launcher's flags set it (:66-76):
  - `--continuous-batching N` (default 4): continuous in-flight batching.
    Default-config SFT requests and streams (default sampling,
    `--continuous-heads` heads, default 2) decode in N shared slots and join
    a decode in flight at a chunk boundary (runtime/continuous.py); other
    requests go through the worker, other streams through the stream lane.
    `--continuous-reserve M` (default 1) keeps M of the slots for streams,
    so that at most N - M take /api/v1/tts traffic and a stream starts at
    the next chunk boundary. On an H100 neither mode has shown lower p50 or
    p95 /api/v1/tts latency than the other under a sustained load
    (tools/serve_load.py; PERF.md §5): the slots synthesise each finished
    row alone on their decode thread, while the window synthesises a
    coalesced group at once.
  - `--continuous-batching 0`: window coalescing. A multi-segment text
    decodes as one flash batch, and concurrent batchable requests are
    coalesced by the server's 0.03 s window into one flash batch of up to 8
    requests (runtime/server.py); every stream takes the stream lane.

`--spec-decode` (JAX :80-85): every decode at two heads or more, on every
route (one utterance, the flash batch, the stream lane, the continuous
slots), drafts with MTP heads 1..K-1 and verifies against head 0, the exact
heads=1 output distribution; with slots it needs `--continuous-heads` >= 2.

The training and model routes (/api/v1/training/*, /api/v1/models/*) run
their jobs as subprocesses of one TrainingManager, whose trainers take this
launcher's --device and --tiny.

`--quantize int8` (default: the HYDRAVOX_QUANTIZE environment variable; JAX
:62-65) serves the LLM as weight-only int8 with per-output-channel scales
(ops/quant.py) on every route, the decode MLP through the int8 form of the
MLP kernel; the flow and HiFT stay bf16 and f32. A hot reload
(/api/v1/load_pt) quantizes the new LLM again.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

from .config import HydraVoxConfig, tiny_config
from .convert import torch_import
from .device import resolve_device
from .frontend.frontend import Frontend, SpeakerInfo
from .frontend.tokenizer import get_tokenizer
from .params import init_flow_params, init_hift_params, init_llm_params
from .runtime.engine import Engine
from .runtime.server import serve
from .runtime.training_manager import TrainingManager


def parse_args(argv=None):
    p = argparse.ArgumentParser("flowmirror_hydravox_tpu_torch")
    p.add_argument("--api-host", default="0.0.0.0")
    p.add_argument("--api-port", type=int, default=8080)
    p.add_argument("--with-ui", action="store_true", help="serve the web UI at GET /")
    p.add_argument("--model-dir", default=os.environ.get("TTS_MODEL_DIR"))
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--spk2info", default=None,
                   help="speaker registry: .npz (save_spk2info) or the reference's .pt")
    p.add_argument("--tiny", action="store_true", help="tiny random config (smoke)")
    p.add_argument("--max-tokens", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--continuous-batching", type=int, default=4, metavar="SLOTS",
                   help="continuous (in-flight) batching over N decode slots; "
                        "0 = window coalescing")
    p.add_argument("--continuous-heads", type=int, default=2,
                   help="inference_head_num served by the continuous slots")
    p.add_argument("--continuous-reserve", type=int, default=1,
                   help="continuous slots reserved for streams (0 = none)")
    p.add_argument("--spec-decode", action="store_true",
                   help="self-speculative MTP decoding: heads 1..K-1 draft, head 0 verifies "
                        "(the exact heads=1 output distribution)")
    p.add_argument("--quantize", default=os.environ.get("HYDRAVOX_QUANTIZE"),
                   choices=[None, "none", "bf16", "int8"],
                   help="weight-only LLM quantization (int8: per-output-channel scales; "
                        "the flow and HiFT are not quantized)")
    return p.parse_args(argv)


def _with_text_vocab(cfg: HydraVoxConfig, vocab: int) -> HydraVoxConfig:
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, backbone=dataclasses.replace(cfg.llm.backbone, vocab_size=vocab)))


def load_models(tiny: bool, model_dir, tokenizer, device, dtype=torch.bfloat16):
    """(cfg, {llm, flow, hift} trees on `device`), the LLM and flow at
    `dtype` (bf16 to serve), HiFT f32: each model from `model_dir`
    (`{name}.npz`, else `{name}.pt`), else random from seed 0. The text vocab
    is llm.pt's, or, for a fresh full-width LLM, the tokenizer's padded to a
    multiple of 128 (JAX __main__.py:111-126)."""
    cfg = tiny_config() if tiny else HydraVoxConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    paths = {name: torch_import.model_file(model_dir, name) for name in ("llm", "flow", "hift")}
    llm_sd = None
    if paths["llm"] and paths["llm"].endswith(".pt"):
        llm_sd = torch_import.load_torch_pt(paths["llm"])
        cfg = _with_text_vocab(cfg, torch_import.text_vocab(llm_sd))
    elif paths["llm"] is None and not tiny:
        padded = -(-tokenizer.vocab_size // 128) * 128
        cfg = _with_text_vocab(cfg, padded)
        logging.info("fresh init: text vocab follows the tokenizer (%d -> padded %d)",
                     tokenizer.vocab_size, padded)
    trees = {}
    for name, init, leaf_dtype, sub in (("llm", init_llm_params, dtype, cfg.llm),
                                        ("flow", init_flow_params, dtype, cfg.flow),
                                        ("hift", init_hift_params, torch.float32, cfg.hift)):
        if paths[name]:
            trees[name] = torch_import.load_tree(paths[name], name, cfg, device, leaf_dtype,
                                                 sd=llm_sd if name == "llm" else None)
            logging.info("loaded %s", paths[name])
        else:
            trees[name] = init(sub, gen, device, leaf_dtype)
    return cfg, trees


def load_registry(frontend: Frontend, path: str):
    """A speaker registry into `frontend`: a `.npz` as `save_spk2info`
    writes it, anything else as the reference's spk2info.pt; a path that
    does not exist is an error."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"speaker registry {path} does not exist")
    if path.endswith(".npz"):
        frontend.load_spk2info_npz(path)
    else:
        frontend.load_spk2info(path)


def build(args):
    """(engine, frontend) as the server runs them."""
    device = resolve_device(args.device)
    tokenizer = get_tokenizer(args.tokenizer_path)
    cfg, trees = load_models(args.tiny, args.model_dir, tokenizer, device)
    engine = Engine(cfg, trees["llm"], trees["flow"], trees["hift"],
                    max_tokens=args.max_tokens, device=device, spec_decode=args.spec_decode,
                    quantize=args.quantize)
    frontend = Frontend(cfg, tokenizer=tokenizer, device=device)
    if args.spk2info:
        load_registry(frontend, args.spk2info)
    if not frontend.available_speakers():
        frontend.add_speaker("default", SpeakerInfo(embedding=np.zeros(192, np.float32)))
    return engine, frontend


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # cuDNN's default convolution algorithms may accumulate in a run-dependent
    # order, and a seeded request (extra_params.seed) then repeats its tokens
    # but not its PCM: one int16 step apart on an H100 (PERF.md §6)
    torch.backends.cudnn.deterministic = True
    engine, frontend = build(args)
    serve(args.api_host, args.api_port, engine, frontend,
          continuous_slots=args.continuous_batching, continuous_head_num=args.continuous_heads,
          continuous_reserve_stream=args.continuous_reserve,
          training=TrainingManager(device=args.device, tiny=args.tiny), with_ui=args.with_ui)


if __name__ == "__main__":
    main()
