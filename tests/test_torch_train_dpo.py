"""DPO training in the port against the JAX package (tiny config, CPU, f32;
the port's seeded tree, its heads' MLP narrowed to 256, crossed through the
npz bridge):

- `dpo_loss` in its three variants (sigmoid, label smoothing, IPO);
- `forward_dpo` with chosen and rejected of unequal lengths and widths:
  loss, acc and both log-probabilities within 1e-5 relative;
- three `dpo_train_step`s against the jitted JAX step: every metric within
  1e-5 + 1e-4 relative, params within 2e-5 x (1 + |p|) at lr 1e-4; the
  reference tree is unchanged and shares no storage with the policy;
- `accum_steps` 2 against JAX's accumulation and the port's full batch;
- `DPOCollator` equals JAX's on the same rows;
- `train_dpo` on a tiny HF dataset (`--device cpu`, `--model_ckpt`,
  `--ref_ckpt`) logs JAX's preference line and saves a train state;
- DPO reaches no kernel, and its gradients are the JAX ones' shape: head
  0's slice of every head leaf but the never-multiplied q/k trains, heads
  1-4 get exactly zero.
"""

import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.frontend.tokenizer import ByteTokenizer as JaxByteTokenizer
from flowmirror_hydravox_tpu.models import llm_extras as jx
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu.train import data as jdata
from flowmirror_hydravox_tpu.train import steps as js
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.frontend.tokenizer import ByteTokenizer
from flowmirror_hydravox_tpu_torch.models import llm_extras as tx
from flowmirror_hydravox_tpu_torch.models import qwen2 as tq
from flowmirror_hydravox_tpu_torch.params import flatten_params, load_params_npz
from flowmirror_hydravox_tpu_torch.train import data, train_dpo
from flowmirror_hydravox_tpu_torch.train import steps as ts
from tests.torch_port_util import jit_o0, n, seeded_tiny_trees, t

CFG = tiny_config().llm
JCFG = jax_tiny_config().llm
KEYS = ts.DPO_KEYS
HEAD_MLP = 256  # the heads' MLP columns of the parity tree (22016 at every size)
OPT = dict(learning_rate=1e-4, warmup_steps=1, total_steps=100)


@pytest.fixture(scope="module")
def npz_tree(tmp_path_factory):
    """The port's seeded f32 tiny LLM tree, its heads' MLP cut to HEAD_MLP
    columns: (numpy tree, path of its npz)."""
    tree = jax.tree.map(np.copy, seeded_tiny_trees()[0])
    heads = tree["mtp_block"]
    for name in ("gate_proj_w", "up_proj_w"):
        heads[name] = np.ascontiguousarray(heads[name][:, :, :HEAD_MLP])
    heads["down_proj_w"] = np.ascontiguousarray(heads["down_proj_w"][:, :HEAD_MLP])
    path = str(tmp_path_factory.mktemp("dpo") / "llm.npz")
    jckpt.save_params_npz(path, tree)
    return tree, path


def _batch(seed, chosen=(12, 7, 3, 10), rejected=(16, 5, 9, 1), text=(8, 5, 3, 6), lc=12,
           lr=16):
    rng = np.random.default_rng(seed)
    b = len(text)
    return {"text_token": rng.integers(0, CFG.backbone.vocab_size, (b, 8)).astype(np.int32),
            "text_len": np.array(text, np.int32),
            "chosen_token": rng.integers(0, CFG.speech_token_size, (b, lc)).astype(np.int32),
            "chosen_len": np.array(chosen, np.int32),
            "rejected_token": rng.integers(0, CFG.speech_token_size, (b, lr)).astype(np.int32),
            "rejected_len": np.array(rejected, np.int32)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_params(jax_params, tree, what):
    want = flatten_params(jax.tree.map(np.asarray, jax_params))
    got = flatten_params(tree)
    for k, w in want.items():
        np.testing.assert_allclose(n(got[k]), w, atol=2e-5, rtol=2e-5, err_msg=f"{what}: {k}")


def _close_metrics(jm, tm, what):
    assert set(tm) == set(jm), what
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what}: {k}")


def test_dpo_loss_matches_jax_in_each_variant():
    rng = np.random.default_rng(0)
    logps = [rng.standard_normal(6).astype(np.float32) * 3 for _ in range(4)]
    for kw in (dict(beta=0.1), dict(beta=0.01, label_smoothing=0.2), dict(beta=0.5, ipo=True)):
        want = jx.dpo_loss(*map(jnp.asarray, logps), **kw)
        got = tx.dpo_loss(*map(t, logps), **kw)
        for g, w, name in zip(got, want, ("loss", "chosen_rewards", "rejected_rewards")):
            np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{kw}: {name}")


def test_forward_dpo_matches_jax(npz_tree):
    tree, path = npz_tree
    batch = _batch(1)
    want = jit_o0(lambda p, *a: jx.forward_dpo(p, JCFG, *a))(
        _jax(tree), *[jnp.asarray(batch[k]) for k in KEYS])
    got = tx.forward_dpo(load_params_npz(path, "cpu"), CFG, *[t(batch[k]) for k in KEYS])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_dpo_train_steps_match_jax(npz_tree):
    tree, path = npz_tree
    batch = _batch(2)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, ts.batch_to(batch, "cpu")
    jopt, topt = js.make_optimizer(js.OptimConfig(**OPT)), ts.Optimizer(ts.OptimConfig(**OPT))
    jstep = jit_o0(lambda s, rp, b: js.dpo_train_step(s, rp, b, JCFG, jopt))
    jstate, jref = js.init_state(_jax(tree), jopt), _jax(tree)
    policy = load_params_npz(path, "cpu")
    ref = train_dpo.frozen_copy(policy)
    for (k, r), (_, p) in zip(ts.tree_leaves(ref), ts.tree_leaves(policy)):
        assert r.data_ptr() != p.data_ptr() and not r.requires_grad, k
    tstate = ts.init_state(policy, topt)
    for i in range(3):
        jstate, jm = jstep(jstate, jref, jb)
        tstate, tm = ts.dpo_train_step(tstate, ref, tb, CFG, topt)
        _close_metrics(jm, tm, f"step {i + 1}")
        _close_params(jstate.params, tstate.params, f"step {i + 1}")
        if i == 0:  # the policy is the reference model
            assert abs(float(tm["dpo_loss"]) - math.log(2)) < 1e-6
            assert float(tm["chosen_reward"]) == float(tm["reject_reward"]) == 0.0
    assert tstate.step == int(jstate.step) == 3
    for k, p in flatten_params(ref).items():
        assert np.array_equal(n(p), flatten_params(tree)[k]), k


def test_dpo_grad_accum_matches_jax_and_the_full_batch(npz_tree):
    tree, path = npz_tree
    # equal rows: the micro-batch means average to the full batch's
    batch = _batch(3, chosen=(12,) * 4, rejected=(12,) * 4, text=(8,) * 4, lr=12)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, ts.batch_to(batch, "cpu")
    jopt, topt = js.make_optimizer(js.OptimConfig(**OPT)), ts.Optimizer(ts.OptimConfig(**OPT))
    jstate, jm = jit_o0(lambda s, rp, b: js.dpo_train_step(s, rp, b, JCFG, jopt, accum_steps=2))(
        js.init_state(_jax(tree), jopt), _jax(tree), jb)
    ref = load_params_npz(path, "cpu")
    acc_state, acc_m = ts.dpo_train_step(ts.init_state(load_params_npz(path, "cpu"), topt), ref,
                                         tb, CFG, topt, accum_steps=2)
    _close_metrics(jm, acc_m, "accum 2 vs JAX")
    _close_params(jstate.params, acc_state.params, "accum 2 vs JAX")
    full_state, full_m = ts.dpo_train_step(ts.init_state(load_params_npz(path, "cpu"), topt), ref,
                                           tb, CFG, topt)
    for k in ("loss", "sft_loss", "dpo_loss", "dpo_acc", "acc"):
        np.testing.assert_allclose(float(acc_m[k]), float(full_m[k]), atol=1e-5, err_msg=k)
    for (k, a), (_, f) in zip(ts.tree_leaves(acc_state.params), ts.tree_leaves(full_state.params)):
        np.testing.assert_allclose(n(a), n(f), atol=2e-5, err_msg=k)


def _dpo_rows(n_rows=16, seed=1):
    rng = np.random.default_rng(seed)
    return [{"text": f"Preference sample {i}: the tiny trainer reads {i * 3} words.",
             "speech_token": rng.integers(0, 50, int(rng.integers(8, 20))).tolist(),
             "reject_speech_token": rng.integers(0, 50, int(rng.integers(8, 40))).tolist()}
            for i in range(n_rows)]


def test_dpo_collator_matches_jax():
    rows = _dpo_rows()
    rows[3] = dict(rows[3], text_token=[5, 6, 7])
    for buckets in ((16, 32, 64), data.SPEECH_BUCKETS):
        got = data.DPOCollator(ByteTokenizer(), speech_buckets=buckets)(rows[:6])
        want = jdata.DPOCollator(JaxByteTokenizer(), speech_buckets=buckets)(rows[:6])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{buckets}: {k}")


def test_train_dpo_cli_logs_preference_metrics(npz_tree, tmp_path, caplog):
    import datasets

    _, path = npz_tree
    ds = str(tmp_path / "dpo_ds")
    datasets.Dataset.from_list(_dpo_rows()).save_to_disk(ds)
    out = str(tmp_path / "run")
    with caplog.at_level(logging.INFO, logger="hydravox.train_dpo"):
        res = train_dpo.main(["--train_data", ds, "--output_dir", out, "--tiny", "--device",
                              "cpu", "--batch_size", "4", "--max_steps", "2", "--logging_steps",
                              "1", "--save_steps", "100", "--learning_rate", "1e-4",
                              "--warmup_steps", "1", "--model_ckpt", path, "--ref_ckpt", path])
    assert res["step"] == 2
    m = res["metrics"]
    for key in ("loss", "grad_norm", "sft_loss", "dpo_loss", "acc", "dpo_acc", "chosen_reward",
                "reject_reward"):
        assert np.isfinite(m[key]), (key, m)
    assert abs(m["loss"] - (m["sft_loss"] + m["dpo_loss"])) < 1e-4, m
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("step ")]
    assert len(lines) == 2 and " dpo_acc " in lines[0] and " rewards " in lines[0], lines
    state = torch.load(os.path.join(out, "step_2.pt"), weights_only=True)
    assert state["step"] == 2 and state["params"]["llm_decoder"].dtype == torch.bfloat16


def test_dpo_reaches_no_kernel(npz_tree, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a DPO forward reached a decode kernel's dispatch")

    monkeypatch.setattr(tq, "decode_mlp", refuse)
    monkeypatch.setattr(tq, "decode_attention_dispatch", refuse)
    _, path = npz_tree
    opt = ts.Optimizer(ts.OptimConfig(**OPT))
    state, _ = ts.dpo_train_step(ts.init_state(load_params_npz(path, "cpu"), opt),
                                 load_params_npz(path, "cpu"), ts.batch_to(_batch(4), "cpu"),
                                 CFG, opt)
    for k, mu in state.opt_state["mu"].items():  # 0.1 x the first step's gradient
        per_head = mu.abs().flatten(1).amax(1) if k.startswith("mtp_block.") else mu.abs().max()
        if not k.startswith("mtp_block."):
            assert float(per_head) > 0, k
        elif k.split(".")[1][:6] in ("q_proj", "k_proj"):
            assert not per_head.any(), k
        else:
            assert float(per_head[0]) > 0 and not per_head[1:].any(), (k, per_head)
