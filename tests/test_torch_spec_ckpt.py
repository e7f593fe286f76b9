"""The spec-decode readout trainer (tools/train_spec_ckpt.py) and
tools/bench_spec.py in the port (tiny config, CPU; the port's seeded tree,
its heads' MLP narrowed to 256, crossed as npz):

- `make_batch` gives the JAX tool's corpus byte for byte;
- one readout step against the JAX tool's jitted step: loss and acc within
  1e-5 relative, the `dec` and `emb` gradients within 1e-5 of each leaf's
  largest; Adam (`readout_optimizer`) against `optax.adam` on the same
  gradients; the same step over a bf16 tree, as the card trains it;
- the artifact round-trips bit for bit (and loads in the JAX loader), and
  `load_spec_readout` refuses a readout over another tree, the JAX
  package's committed one too;
- drafts agree more after a short training: acceptance under deterministic
  sampling rises (the port's form of JAX tests/test_llm.py:374);
- `train_spec_ckpt` and `bench_spec --tiny --device cpu`, untrained and
  `--trained`, print their lines; `--train_on_chip`'s in-process training
  trains.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.tools import train_spec_ckpt as jtool
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.noise import TorchNoise
from flowmirror_hydravox_tpu_torch.ops.sampling import SamplingParams
from flowmirror_hydravox_tpu_torch.params import load_params_npz
from flowmirror_hydravox_tpu_torch.tools import bench_spec
from flowmirror_hydravox_tpu_torch.tools import train_spec_ckpt as tool
from flowmirror_hydravox_tpu_torch.train.steps import batch_to
from tests.torch_port_util import n, seeded_tiny_trees, t

CFG = tiny_config()
JCFG = jax_tiny_config()
ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ARTIFACT = ROOT / "flowmirror_hydravox_tpu" / "assets" / "spec_readout.npz"
M = 16  # corpus alphabet of the CPU runs
SHAPE = dict(b=2, lt_max=8, ls=16, m_tokens=M)
TINY_TREE = tool.tree_meta(True, CFG.llm.backbone.vocab_size, "cpu", torch.float32)


@pytest.fixture(scope="module")
def npz_tree(tmp_path_factory):
    tree = jax.tree.map(np.copy, seeded_tiny_trees()[0])
    heads = tree["mtp_block"]
    for name in ("gate_proj_w", "up_proj_w"):
        heads[name] = np.ascontiguousarray(heads[name][:, :, :256])
    heads["down_proj_w"] = np.ascontiguousarray(heads["down_proj_w"][:, :256])
    path = str(tmp_path_factory.mktemp("spec") / "llm.npz")
    jckpt.save_params_npz(path, tree)
    return tree, path


def test_make_batch_matches_jax():
    for kw in (SHAPE, dict(b=4, lt_max=64, ls=160, m_tokens=256)):
        got_rng, want_rng = np.random.default_rng(0), np.random.default_rng(0)
        for _ in range(3):
            got = tool.make_batch(got_rng, CFG, **kw)
            want = jtool.make_batch(want_rng, JCFG, **kw)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def _jax_step(opt):
    """The JAX tool's training step (train_spec_ckpt.py:156-180), returning
    the gradients too."""

    def loss_fn(tr, frozen_p, batch):
        full = dict(frozen_p, llm_decoder=tr["dec"])
        e = frozen_p["speech_embedding"]
        full["speech_embedding"] = e.at[: tr["emb"].shape[0]].set(tr["emb"].astype(e.dtype))
        out = jl.forward_loss(full, JCFG.llm, batch["text_token"], batch["text_len"],
                              batch["speech_token"], batch["speech_len"])
        return out["loss"], out["acc"]

    @jax.jit
    def step(tr, opt_state, frozen_p, batch):
        (loss, acc), g = jax.value_and_grad(loss_fn, has_aux=True)(tr, frozen_p, batch)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(tr, upd), opt_state, loss, acc, g

    return step


def test_readout_step_matches_jax(npz_tree):
    tree, path = npz_tree
    lr = 2e-3
    params = load_params_npz(path, "cpu")
    frozen = {k: v for k, v in params.items() if k != "llm_decoder"}
    jfrozen = {k: jax.tree.map(jnp.asarray, v) for k, v in tree.items() if k != "llm_decoder"}
    jopt = optax.adam(lr)
    jtr = {"dec": jnp.asarray(tree["llm_decoder"]), "emb": jnp.asarray(tree["speech_embedding"][:M])}
    jstate = jopt.init(jtr)
    step = _jax_step(jopt)
    rng = np.random.default_rng(0)
    batches = [tool.make_batch(rng, CFG, **SHAPE) for _ in range(2)]

    tr = tool.trainable(params, M)
    for v in tr.values():
        v.requires_grad_(True)
    opt = tool.readout_optimizer(lr)
    opt_state = opt.init(tr)
    loss, acc, grads = tool.readout_step(tr, opt, opt_state, frozen, CFG.llm,
                                         batch_to(batches[0], "cpu"))
    # Adam on the JAX step's own gradients, step by step, against optax
    adam_tr = {k: t(np.asarray(v)).requires_grad_(True) for k, v in jtr.items()}
    adam_state = opt.init(adam_tr)
    for i, batch in enumerate(batches):
        jtr, jstate, jloss, jacc, jg = step(jtr, jstate, jfrozen, jax.tree.map(jnp.asarray, batch))
        if i == 0:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5)
            for k in ("dec", "emb"):
                w = np.asarray(jg[k])
                np.testing.assert_allclose(n(grads[k]), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                           err_msg=k)
        opt.apply(adam_tr, {k: t(np.asarray(v)) for k, v in jg.items()}, adam_state)
        for k in ("dec", "emb"):
            np.testing.assert_allclose(n(adam_tr[k]), np.asarray(jtr[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"Adam step {i + 1}: {k}")
    assert adam_state["count"] == int(jstate[0].count) == 2
    # the card trains f32 leaves over a bf16 tree (the decoder product
    # promoted to f32, as jnp.matmul promotes it)
    bf16 = {k: v for k, v in load_params_npz(path, "cpu", torch.bfloat16).items()
            if k != "llm_decoder"}
    loss16, _ = tool.readout_loss(tool.trainable(params, M), bf16, CFG.llm,
                                  batch_to(batches[0], "cpu"))
    assert loss16.dtype == torch.float32
    np.testing.assert_allclose(float(loss16), float(loss), rtol=2e-2)


def test_artifact_round_trips_and_refuses_other_trees(npz_tree, tmp_path):
    tree, path = npz_tree
    fresh = load_params_npz(path, "cpu")
    before = {k: fresh[k].clone() for k in ("llm_decoder", "speech_embedding")}
    gen = torch.Generator().manual_seed(3)
    tr = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
          for k, v in tool.trainable(fresh, M).items()}
    out = str(tmp_path / "readout.npz")
    tool.save_spec_readout(out, tr, dict(TINY_TREE, steps=0))
    loaded, meta = tool.load_spec_readout(fresh, out, TINY_TREE)
    assert meta["steps"] == 0
    want = tool.with_readout(fresh, tr)
    for k in ("llm_decoder", "speech_embedding"):
        assert torch.equal(loaded[k], want[k]), k
        assert torch.equal(fresh[k], before[k]), k  # the given tree is not changed
    assert torch.equal(loaded["llm_decoder"], tr["dec"].to(torch.bfloat16).float())
    assert torch.equal(loaded["speech_embedding"][M:], before["speech_embedding"][M:])
    # JAX's format: the JAX loader reads the same values
    jparams, _ = jtool.load_spec_readout(jax.tree.map(jnp.asarray, tree), out)
    for k in ("llm_decoder", "speech_embedding"):
        np.testing.assert_array_equal(np.asarray(jparams[k]), n(loaded[k]), err_msg=k)
    for other in (dict(TINY_TREE, generator="cuda"), dict(TINY_TREE, text_vocab=60800),
                  dict(TINY_TREE, dtype="bfloat16")):
        with pytest.raises(ValueError, match="another tree"):
            tool.load_spec_readout(fresh, out, other)
    with pytest.raises(ValueError, match="another tree"):
        tool.load_spec_readout(fresh, str(JAX_ARTIFACT), TINY_TREE)


def test_acceptance_rises_after_readout_training(npz_tree):
    _, path = npz_tree
    params = load_params_npz(path, "cpu")
    det = SamplingParams.make(top_p=0.5, top_k=1, win_size=10, tau_r=2.0)
    text = torch.arange(24, dtype=torch.int32)
    emb, plen = tl.build_inference_prompt(params, CFG.llm, text, 24,
                                          torch.zeros(0, dtype=torch.int32), 0)

    def acceptance(p):
        with torch.no_grad():
            r = tl.generate_speculative(p, CFG.llm, emb, plen, 48, 48, det,
                                        TorchNoise(torch.Generator().manual_seed(1)),
                                        num_heads=4, max_tokens=64)
        return int(r.accepted) / max(int(r.drafted), 1), int(r.result.steps)

    before, steps_before = acceptance(params)
    tr, history = tool.train_readout(params, CFG.llm, steps=200, batch=4, lt_max=24, ls=56,
                                     m_tokens=M, lr=1e-2, log=lambda line: None)
    assert history[-1][0] == 199 and history[-1][2] > history[0][2] + 0.5, history
    after, steps_after = acceptance(tool.with_readout(params, tr))
    assert after > before + 0.15 and steps_after < steps_before, (before, after)


def test_tools_print_their_lines(npz_tree, tmp_path, capsys):
    out = str(tmp_path / "readout.npz")
    line = tool.main(["--tiny", "--device", "cpu", "--steps", "2", "--batch", "2", "--lt_max",
                      "8", "--ls", "16", "--out", out])
    assert line["metric"] == "spec_readout_eval" and 0 <= line["acceptance"] <= 1
    with np.load(out) as z:
        meta = json.loads(str(z["meta"]))
    assert {k: meta[k] for k in tool.TREE_KEYS} == TINY_TREE and meta["steps"] == 2
    args = ["--tiny", "--device", "cpu", "--reps", "1", "--tokens", "16", "--text_len", "8"]
    untrained = bench_spec.main(args)
    assert set(untrained) == {"spec_best_tps", "heads1_best_tps", "speedup", "acceptance",
                              "tokens_per_step"}
    trained = bench_spec.main(args + ["--trained", "--ckpt", out])
    assert trained["metric"] == "spec_decode_trained_heads4" and trained["value"] > 0
    lines = capsys.readouterr().out.splitlines()
    per_rep = [json.loads(x) for x in lines if x.startswith('{"mode"')]
    assert [r["mode"] for r in per_rep] == ["spec4", "heads1"], lines
    assert all(r["toks"] == 16 for r in per_rep)
    # --trained --train_on_chip: the whole LLM trained in-process (20 steps
    # at least, as in JAX), here on the narrowed tree
    params = load_params_npz(npz_tree[1], "cpu")
    decoder = params["llm_decoder"].clone()
    trained_params, acc = bench_spec.train_in_process(CFG.llm, params, 2, True, "cpu")
    assert 0 < acc <= 1 and not torch.equal(trained_params["llm_decoder"], decoder)
