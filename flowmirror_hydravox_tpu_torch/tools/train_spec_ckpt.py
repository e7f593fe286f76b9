"""Train the spec-decode readout over the port's own seed-0 tree: port of
flowmirror_hydravox_tpu/tools/train_spec_ckpt.py.

    python -m flowmirror_hydravox_tpu_torch.tools.train_spec_ckpt \
        [--steps 400] [--out chiprun_out/spec_readout.npz] [--device cuda|cpu] [--tiny]

Speculative decoding (models/llm.py `generate_speculative`) drafts with MTP
heads 1..K-1 and verifies with head 0. Acceptance needs head 0's
distribution to be predictable and the drafts to match it, which needs no
trained backbone: with the backbone and the head transforms frozen at their
seeded init, each head k is a fixed random feature map of the hidden state,
and training only the shared `llm_decoder` readout (and the corpus
alphabet's `speech_embedding` rows) on a cyclic-successor corpus
(speech_token[t] = (start + t) % M) makes head 0 predict the successor and
head k the k-step successor. The artifact is those trained values alone;
everything else regenerates from the seed.

The frozen tree is the one `__main__.load_models` draws with no model
directory: `torch.Generator(device=device).manual_seed(0)` (a card draw is
not a CPU draw), the text vocab the tokenizer's padded to a multiple of 128
at full width, bf16 (f32 at `--tiny`). The artifact's `meta` records what
fixes that tree (config, text vocab, seed, the generator's device, dtype),
and `load_spec_readout` refuses a readout trained over another tree with a
ValueError: a readout over other features is noise. That includes the JAX
package's `assets/spec_readout.npz`, trained over the JAX `PRNGKey(0)`
tree, which torch cannot draw (the JAX loader only warns).

Training (JAX :156-205): `forward_loss` in its training form over the
frozen tree with the decoder and the rows in f32, plain Adam as
`optax.adam(lr)` computes it (no clip, no decay, eps 1e-8), a fresh batch
of the corpus each step from `np.random.default_rng(0)`. The artifact has
JAX's format (`llm_decoder_bf16_bits`, `speech_embedding_rows_bf16_bits`:
uint16 views of bf16, exact; `meta`: JSON). The corpus is synthetic, so the
acceptance it yields demonstrates that the decode turns agreeing heads into
tokens per step; real speech lands wherever real MTP training puts it.
Then the eval (JAX :215-265): spec decodes at heads 4 at the bench's
design point (tools/bench_spec.py), the best by tokens/s in one
`spec_readout_eval` line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "spec_readout.npz")
SEED = 0  # the launcher's seed for a fresh tree
TREE_KEYS = ("config", "text_vocab", "seed", "generator", "dtype")


def tree_meta(tiny: bool, text_vocab: int, device, dtype) -> dict:
    """What fixes the seed-0 LLM tree a readout trains over."""
    return {"config": "tiny" if tiny else "flagship", "text_vocab": int(text_vocab),
            "seed": SEED, "generator": torch.device(device).type,
            "dtype": str(dtype).replace("torch.", "")}


def load_tree(tiny: bool, device, tokenizer=None):
    """(cfg, {llm, flow, hift}, tree_meta) of the launcher's seed-0 draw."""
    from .. import __main__ as launcher
    from ..frontend.tokenizer import get_tokenizer

    dtype = torch.float32 if tiny else torch.bfloat16
    cfg, trees = launcher.load_models(tiny, None, tokenizer or get_tokenizer(), device, dtype)
    return cfg, trees, tree_meta(tiny, cfg.llm.backbone.vocab_size, device, dtype)


def load_spec_readout(params: dict, path: str, tree: dict):
    """(`params` with `llm_decoder` and the trained `speech_embedding` rows
    replaced by the artifact's, bit for bit; the artifact's meta). `tree`
    is `tree_meta` of `params`; a readout trained over another tree raises
    ValueError. `params` itself is not changed."""
    with np.load(path) as z:
        tr = {"dec": _from_bits(z["llm_decoder_bf16_bits"])}
        meta = json.loads(str(z["meta"]))
        if "speech_embedding_rows_bf16_bits" in z:
            tr["emb"] = _from_bits(z["speech_embedding_rows_bf16_bits"])
    trained_over = {k: meta.get(k) for k in TREE_KEYS}
    if trained_over != tree:
        raise ValueError(f"spec readout {path} was trained over another tree ({trained_over}, "
                         f"prng_impl {meta.get('prng_impl')}); this tree is {tree}: retrain it "
                         f"with tools/train_spec_ckpt.py")
    dec, emb = params["llm_decoder"], params["speech_embedding"]
    if tr["dec"].shape != dec.shape:
        raise ValueError(f"readout decoder {tuple(tr['dec'].shape)} != model {tuple(dec.shape)}")
    if "emb" in tr and (tr["emb"].shape[1] != emb.shape[1] or tr["emb"].shape[0] > emb.shape[0]):
        raise ValueError(f"readout rows {tuple(tr['emb'].shape)} do not fit {tuple(emb.shape)}")
    return with_readout(params, tr), meta


def _from_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def make_batch(rng, cfg, b, lt_max, ls, m_tokens):
    """Cyclic-successor corpus rows: a random text prefix (of random length,
    so speech positions cover the serving RoPE range), then speech_token[t]
    = (start + t) % M."""
    lts = rng.integers(4, lt_max + 1, (b,))
    starts = rng.integers(0, m_tokens, (b, 1))
    return {
        "text_token": rng.integers(0, 1000, (b, lt_max)).astype(np.int32),
        "text_len": lts.astype(np.int32),
        "speech_token": ((starts + np.arange(ls)[None, :]) % m_tokens).astype(np.int32),
        "speech_len": np.full((b,), ls, np.int32),
    }


def readout_optimizer(lr: float):
    """`optax.adam(lr)`: the trainers' clip + AdamW with neither clip nor
    decay (eps 1e-8, moments in the f32 leaves' dtype)."""
    from ..train.steps import OptimConfig, Optimizer

    return Optimizer(OptimConfig(learning_rate=lr, schedule="constant", weight_decay=0.0,
                                 grad_clip=math.inf))


def trainable(params: dict, m_tokens: int, train_emb: bool = True) -> dict:
    """The readout's trained leaves in f32: {"dec": llm_decoder, "emb": the
    first m_tokens speech_embedding rows}."""
    tr = {"dec": params["llm_decoder"].detach().to(torch.float32).clone()}
    if train_emb:
        tr["emb"] = params["speech_embedding"][:m_tokens].detach().to(torch.float32).clone()
    return tr


def readout_loss(tr: dict, frozen: dict, cfg, batch: dict):
    """(loss, acc) of `forward_loss` over the frozen tree with the trained
    leaves in place (the rows cast to the tree's dtype)."""
    from ..models.llm import forward_loss

    full = dict(frozen, llm_decoder=tr["dec"])
    if "emb" in tr:
        e = frozen["speech_embedding"]
        full["speech_embedding"] = torch.cat([tr["emb"].to(e.dtype), e[tr["emb"].shape[0]:]])
    out = forward_loss(full, cfg, batch["text_token"], batch["text_len"], batch["speech_token"],
                       batch["speech_len"])
    return out["loss"], out["acc"]


def readout_step(tr: dict, opt, opt_state: dict, frozen: dict, cfg, batch: dict):
    """One Adam step of the trained leaves, in place. Returns (loss, acc,
    the gradients {"dec", "emb"})."""
    from ..train.steps import _value_and_grad_accum

    loss, acc, grads = _value_and_grad_accum(
        lambda p, mb: readout_loss(p, frozen, cfg, mb), tr, batch, 1)
    opt.apply(tr, grads, opt_state)
    return loss, acc, grads


def train_readout(params: dict, cfg, *, steps=400, batch=4, lt_max=64, ls=160, m_tokens=256,
                  lr=2e-3, train_emb=True, log=print):
    """Train the readout over the frozen `params` (JAX :156-205). Returns
    (the trained f32 leaves, [(step, loss, acc)] every 50 steps and the
    last)."""
    from ..train.steps import batch_to

    device = params["llm_decoder"].device
    frozen = {k: v for k, v in params.items() if k != "llm_decoder"}
    tr = trainable(params, m_tokens, train_emb)
    for v in tr.values():
        v.requires_grad_(True)
    opt = readout_optimizer(lr)
    opt_state = opt.init(tr)
    rng = np.random.default_rng(0)
    history = []
    t0 = time.time()
    for i in range(steps):
        b = batch_to(make_batch(rng, cfg, batch, lt_max, ls, m_tokens), device)
        loss, acc, _ = readout_step(tr, opt, opt_state, frozen, cfg, b)
        if i % 50 == 0 or i == steps - 1:
            history.append((i, float(loss), float(acc)))
            log(f"# step {i}: loss {float(loss):.3f} acc {float(acc):.3f} "
                f"({time.time() - t0:.0f}s)")
    return {k: v.detach() for k, v in tr.items()}, history


def save_spec_readout(path: str, tr: dict, meta: dict):
    """The artifact in JAX's format: bf16 bit patterns and a JSON meta."""
    arrays = {"llm_decoder_bf16_bits": _bf16_bits(tr["dec"]), "meta": json.dumps(meta)}
    if "emb" in tr:
        arrays["speech_embedding_rows_bf16_bits"] = _bf16_bits(tr["emb"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def _bf16_bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.bfloat16).cpu().view(torch.int16).numpy().view(np.uint16)


def with_readout(params: dict, tr: dict) -> dict:
    """`params` with the readout's leaves rounded to bf16, as the artifact
    stores them, then cast to the tree's dtype and device (`params` itself
    is not changed)."""
    def like(x, leaf):
        return x.to(leaf.device, torch.bfloat16).to(leaf.dtype)

    out = dict(params, llm_decoder=like(tr["dec"], params["llm_decoder"]))
    if "emb" in tr:
        e = params["speech_embedding"].detach().clone()
        e[: tr["emb"].shape[0]] = like(tr["emb"], e)
        out["speech_embedding"] = e
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lt_max", type=int, default=64)
    p.add_argument("--ls", type=int, default=160,
                   help="train speech length; must cover the serving position range "
                        "(bench: 2 + 63 text + 125 tokens)")
    p.add_argument("--m_tokens", type=int, default=256,
                   help="cyclic corpus alphabet (> RAS win_size so the repetition fallback "
                        "never triggers)")
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--decoder_only", action="store_true",
                   help="freeze the speech-embedding rows too (a smaller artifact, lower "
                        "acceptance)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--eval_only", action="store_true",
                   help="skip training; evaluate the existing --out artifact")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..frontend.tokenizer import get_tokenizer
    from . import bench_spec

    device = resolve_device(args.device)
    cfg, trees, tree = load_tree(args.tiny, device, get_tokenizer(args.tokenizer_path))
    m_tokens = min(args.m_tokens, cfg.llm.speech_token_size)
    if args.eval_only:
        trees["llm"], meta = load_spec_readout(trees["llm"], args.out, tree)
        train_acc = meta.get("train_acc", -1.0)
    else:
        tr, history = train_readout(
            trees["llm"], cfg.llm, steps=args.steps, batch=args.batch, lt_max=args.lt_max,
            ls=args.ls, m_tokens=m_tokens, lr=args.lr, train_emb=not args.decoder_only,
            log=lambda line: print(line, flush=True))
        train_acc = history[-1][2]
        meta = dict(tree, steps=args.steps, batch=args.batch, lt_max=args.lt_max, ls=args.ls,
                    m_tokens=m_tokens, lr=args.lr, train_embedding=not args.decoder_only,
                    train_acc=round(train_acc, 4), torch=torch.__version__,
                    recipe="shared-decoder readout (+ corpus-alphabet embedding rows) on a "
                           "cyclic-successor corpus; backbone and heads frozen at the "
                           "launcher's seed-0 init (tools/train_spec_ckpt.py)")
        save_spec_readout(args.out, tr, meta)
        print(f"# saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)
        trees["llm"] = with_readout(trees["llm"], tr)

    # the eval (JAX :215-265): the best of 2 seeded spec decodes at heads 4 at
    # the bench's design point, after a warm-up
    n_tokens, text_len = (48, 24) if args.tiny else (125, 63)
    best = bench_spec.bench(bench_spec.spec_engine(cfg, trees, n_tokens, device), 4, 2,
                            n_tokens, text_len, verbose=False)
    line = dict(metric="spec_readout_eval", train_acc=train_acc,
                acceptance=round(best.spec_acceptance, 3),
                tokens_per_step=round(len(best.speech_tokens) / max(best.steps, 1), 2),
                tps=round(best.tps, 1))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
