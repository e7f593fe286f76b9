"""LLM (MTP) training in the port against the JAX package (tiny config, CPU,
f32, a JAX-initialised tree, its heads' MLP narrowed to 256, crossed through
the npz bridge):

- `qwen2.forward` (the full causal forward with right-padding lengths)
  within 1e-5;
- `forward_loss` (inputs, shifted targets, fused CE) at lsm_weight 0 and 0.1
  with and without length normalisation: loss within 1e-5 relative, acc
  exact, inputs and targets exact;
- every leaf's gradient against `jax.grad` within 1e-4 of its largest
  magnitude, exact zeros where JAX's are zero;
- three `llm_train_step`s under each of the four schedules (params within
  1e-5 + 1e-4 |p|, metrics likewise), and the values of each schedule,
  noam's without hold too;
- a non-finite gradient norm skips the update but not the step;
- `accum_steps` 2 against JAX's accumulation and the full batch;
- the optimizer against optax on synthetic gradients, clipped and not: f32
  within 1e-6, a bf16 tree with bf16 moments within one bf16 rounding, the
  decay of a leaf that never gets a gradient;
- training reaches neither kernel (the heads' MLP trains as `_mlp_block`;
  the port's seeded tree), and both kernels' wrappers refuse inputs that
  need a gradient.

The learning rate is 1e-4 where params are compared: Adam's first steps turn
a gradient near zero into a step of up to +-lr, and a few gradients of
~1e-8 (sums that cancel) differ by a few percent between XLA's and torch's
summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.models import qwen2 as jq
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu.train import steps as js
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.models import qwen2 as tq
from flowmirror_hydravox_tpu_torch.ops import decode_attention as tda
from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as tmlp
from flowmirror_hydravox_tpu_torch.params import flatten_params, load_params_npz
from flowmirror_hydravox_tpu_torch.train import steps as ts
from tests.torch_port_util import jit_o0, n, seeded_tiny_trees, t

CFG = tiny_config().llm
JCFG = jax_tiny_config().llm
KEYS = ("text_token", "text_len", "speech_token", "speech_len")
# the four branches of make_schedule; noam (no hold) shares noamhold's code
# and is held to JAX by its values alone
SCHEDULES = ("warmup_cosine", "constant", "warmuplr", "noamhold")
# the JAX init gives the heads' MLP the reference's 22016 columns at every
# size: 12.7 M of the tiny tree's 12.8 M params, which made each step and its
# comparison cost ~0.4 s on one thread. Both packages read the width from the
# weights, so the parity tests run on a narrower head MLP.
HEAD_MLP = 256


def _batch(seed, lengths=((8, 16), (5, 9), (3, 12), (7, 4))):
    rng = np.random.default_rng(seed)
    b, lt, ls = len(lengths), 8, 16
    return {"text_token": rng.integers(0, CFG.backbone.vocab_size, (b, lt)).astype(np.int32),
            "text_len": np.array([a for a, _ in lengths], np.int32),
            "speech_token": rng.integers(0, CFG.speech_token_size, (b, ls)).astype(np.int32),
            "speech_len": np.array([s for _, s in lengths], np.int32)}


def _loss_and_acc(params, *batch):
    out = jl.forward_loss(params, JCFG, *batch)
    return out["loss"], out["acc"]


# JAX's loss, accuracy and gradients at JCFG: one compile for the module's
# tests (the batches share one shape)
_JAX_VALUE_AND_GRAD = jit_o0(jax.value_and_grad(_loss_and_acc, has_aux=True))


@pytest.fixture(scope="module")
def npz_tree(tmp_path_factory):
    """A JAX-initialised f32 LLM tree, its heads' MLP cut to the first
    HEAD_MLP of its 22016 columns: (numpy tree, path of its npz)."""
    tree = jax.tree.map(np.asarray, jit_o0(lambda k: jl.init_params(k, JCFG, jnp.float32))(
        jax.random.PRNGKey(0)))
    heads = tree["mtp_block"]
    for name in ("gate_proj_w", "up_proj_w"):
        heads[name] = np.ascontiguousarray(heads[name][:, :, :HEAD_MLP])
    heads["down_proj_w"] = np.ascontiguousarray(heads["down_proj_w"][:, :HEAD_MLP])
    path = str(tmp_path_factory.mktemp("llm") / "llm.npz")
    jckpt.save_params_npz(path, tree)
    return tree, path


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_params(jax_params, state, what):
    want = flatten_params(jax.tree.map(np.asarray, jax_params))
    got = flatten_params(state.params)
    for k, w in want.items():
        np.testing.assert_allclose(n(got[k]), w, atol=1e-5, rtol=1e-4, err_msg=f"{what}: {k}")


def _close_metrics(jm, tm, what):
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what}: {k}")


def test_forward_matches_jax(npz_tree):
    tree, path = npz_tree
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 11, CFG.backbone.hidden_size)).astype(np.float32)
    lengths = np.array([11, 6, 1], np.int32)
    want = jit_o0(lambda p, *a: jq.forward(p, JCFG.backbone, *a))(
        _jax(tree)["backbone"], jnp.asarray(x), jnp.asarray(lengths))
    got = tq.forward(load_params_npz(path, "cpu")["backbone"], CFG.backbone, t(x), t(lengths))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_forward_loss_matches_jax_for_each_loss_option(npz_tree):
    tree, path = npz_tree
    jp, tp = _jax(tree), load_params_npz(path, "cpu")
    batch = _batch(2)
    jb, tb = [jnp.asarray(batch[k]) for k in KEYS], [t(batch[k]) for k in KEYS]
    t_total = 2 + batch["text_token"].shape[1] + batch["speech_token"].shape[1]
    lm_in, lm_len, targets = jit_o0(lambda p, *b: (*jl.build_lm_input(p, JCFG, *b),
                                                   jl.build_lm_targets(JCFG, *b[1:], t_total)))(
        jp, *jb)
    got_in, got_len = tl.build_lm_input(tp, CFG, *tb)
    np.testing.assert_array_equal(n(got_in), np.asarray(lm_in))
    np.testing.assert_array_equal(n(got_len), np.asarray(lm_len))
    np.testing.assert_array_equal(n(tl.build_lm_targets(CFG, *tb[1:], t_total)),
                                  np.asarray(targets))
    options = [(lsm, norm) for lsm in (0.0, 0.1) for norm in (True, False)]
    jcfgs = [dataclasses.replace(JCFG, lsm_weight=lsm, length_normalized_loss=norm)
             for lsm, norm in options]
    # JCFG's own option comes from the module's value-and-grad program, the
    # other three from one program
    assert (JCFG.lsm_weight, JCFG.length_normalized_loss) == options[0]
    (loss, acc), _ = _JAX_VALUE_AND_GRAD(jp, *jb)
    wants = [{"loss": loss, "acc": acc}] + jit_o0(
        lambda p, *b: [jl.forward_loss(p, c, *b) for c in jcfgs[1:]])(jp, *jb)
    for (lsm, norm), want in zip(options, wants):
        what = f"lsm_weight {lsm}, length_normalized_loss {norm}"
        tcfg = dataclasses.replace(CFG, lsm_weight=lsm, length_normalized_loss=norm)
        got = tl.forward_loss(tp, tcfg, *tb)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5,
                                   err_msg=what)
        assert float(got["acc"]) == float(want["acc"]), what


def test_gradients_match_jax(npz_tree):
    tree, path = npz_tree
    batch = _batch(3)
    jb = [jnp.asarray(batch[k]) for k in KEYS]
    _, want = _JAX_VALUE_AND_GRAD(_jax(tree), *jb)
    want = flatten_params(jax.tree.map(np.asarray, want))
    leaves = ts.tree_leaves(load_params_npz(path, "cpu"))
    for _, p in leaves:
        p.requires_grad_(True)
    loss = tl.forward_loss(_tree_of(leaves), CFG, *[t(batch[k]) for k in KEYS])["loss"]
    grads = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
    for (k, _), g in zip(leaves, grads):
        w = want[k]
        got = np.zeros_like(w) if g is None else n(g)
        np.testing.assert_allclose(got, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=k)
        assert np.array_equal(got == 0, w == 0) or not (w == 0).any(), k


def _tree_of(leaves):
    from flowmirror_hydravox_tpu_torch.params import unflatten_params

    return unflatten_params(dict(leaves))


def test_train_steps_match_jax_under_each_schedule(npz_tree):
    """The JAX step as `llm_train_step` composes it (steps.py:181-201):
    `jax.value_and_grad` of `forward_loss`, then `_apply_grads`; the model
    compiles once for the module, the optimizer once for each schedule."""
    tree, path = npz_tree
    batch = _batch(4)
    jb = [jnp.asarray(batch[k]) for k in KEYS]
    tb = ts.batch_to(batch, "cpu")
    for schedule in SCHEDULES:
        oc = dict(learning_rate=1e-4, warmup_steps=2, total_steps=6, schedule=schedule)
        jopt, topt = js.make_optimizer(js.OptimConfig(**oc)), ts.Optimizer(ts.OptimConfig(**oc))
        for name in ((schedule, "noam") if schedule == "noamhold" else (schedule,)):
            want = js.make_schedule(js.OptimConfig(**{**oc, "schedule": name}))
            got = ts.make_schedule(ts.OptimConfig(**{**oc, "schedule": name}))
            for count in range(9):
                np.testing.assert_allclose(got(count), float(want(jnp.int32(count))),
                                           rtol=1e-6, err_msg=f"{name} at count {count}")
        jstate, tstate = js.init_state(_jax(tree), jopt), ts.init_state(load_params_npz(path, "cpu"), topt)
        apply = jit_o0(lambda s, g: js._apply_grads(s, g, jopt))
        for i in range(3):
            (loss, acc), grads = _JAX_VALUE_AND_GRAD(jstate.params, *jb)
            jstate, gnorm = apply(jstate, grads)
            jm = {"loss": loss, "acc": acc, "grad_norm": gnorm}
            tstate, tm = ts.llm_train_step(tstate, tb, CFG, topt)
            _close_metrics(jm, tm, f"{schedule} step {i + 1}")
            _close_params(jstate.params, tstate, f"{schedule} step {i + 1}")
        assert tstate.step == int(jstate.step) == 3
        assert tstate.opt_state["count"] == 3


def test_nonfinite_gradient_skips_the_update(npz_tree):
    tree, path = npz_tree
    oc = js.OptimConfig(learning_rate=1e-4, warmup_steps=4, total_steps=20, schedule="warmuplr")
    jopt, topt = js.make_optimizer(oc), ts.Optimizer(ts.OptimConfig(**dataclasses.asdict(oc)))
    jstate, tstate = js.init_state(_jax(tree), jopt), ts.init_state(load_params_npz(path, "cpu"), topt)
    before = {k: p.detach().clone() for k, p in ts.tree_leaves(tstate.params)}
    rng = np.random.default_rng(5)
    finite = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
              for k, v in flatten_params(tree).items()}
    bad = dict(finite)
    bad["llm_decoder"] = np.full_like(finite["llm_decoder"], np.nan)
    apply = jit_o0(lambda s, g: js._apply_grads(s, g, jopt))
    for grads, finite_norm in ((bad, False), (finite, True)):
        jgrads = _jax(_tree_of(list(grads.items())))
        jstate, jnorm = apply(jstate, jgrads)
        tnorm = ts._apply(tstate, {k: t(v) for k, v in grads.items()}, topt)
        assert bool(np.isfinite(float(tnorm))) == finite_norm
        if not finite_norm:
            assert tstate.step == 1 and tstate.opt_state["count"] == 0
            for k, p in ts.tree_leaves(tstate.params):
                assert torch.equal(p.detach(), before[k]), k
            assert all(not m.any() for m in tstate.opt_state["mu"].values())
    # the applied update ran at count 0 of the schedule, as JAX's did
    assert tstate.step == int(jstate.step) == 2 and tstate.opt_state["count"] == 1
    _close_params(jstate.params, tstate, "update after a skipped step")


def test_grad_accum_matches_jax_and_the_full_batch(npz_tree):
    tree, path = npz_tree
    batch = _batch(6, lengths=((6, 12),) * 4)  # equal rows: the micro means average to the full
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = ts.batch_to(batch, "cpu")
    oc = dict(learning_rate=1e-4, warmup_steps=1, total_steps=100)
    jopt, topt = js.make_optimizer(js.OptimConfig(**oc)), ts.Optimizer(ts.OptimConfig(**oc))
    jstate, jm = jit_o0(lambda s, b: js.llm_train_step(s, b, JCFG, jopt, accum_steps=2))(
        js.init_state(_jax(tree), jopt), jb)
    acc_state, acc_m = ts.llm_train_step(ts.init_state(load_params_npz(path, "cpu"), topt), tb,
                                         CFG, topt, accum_steps=2)
    _close_metrics(jm, acc_m, "accum 2 vs JAX")
    _close_params(jstate.params, acc_state, "accum 2 vs JAX")
    full_state, full_m = ts.llm_train_step(ts.init_state(load_params_npz(path, "cpu"), topt), tb,
                                           CFG, topt)
    np.testing.assert_allclose(float(acc_m["loss"]), float(full_m["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(acc_m["grad_norm"]), float(full_m["grad_norm"]), rtol=1e-4)
    for (k, a), (_, f) in zip(ts.tree_leaves(acc_state.params), ts.tree_leaves(full_state.params)):
        np.testing.assert_allclose(n(a), n(f), atol=2e-5, err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        ts.llm_train_step(acc_state, tb, CFG, topt, accum_steps=3)


def test_optimizer_matches_optax_on_f32_and_bf16_trees():
    rng = np.random.default_rng(7)
    shapes = {"a": (7, 5), "b.c": (11,), "b.d": (3, 4), "never": (2, 3)}
    p32 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    steps[1] = {k: v * 1e-3 for k, v in steps[1].items()}  # under the clip
    for g in steps:
        g["never"][:] = 0.0  # decays, never gets a gradient
    oc = dict(learning_rate=3e-2, warmup_steps=1, total_steps=10, schedule="constant",
              weight_decay=0.1)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, dict(atol=1e-6, rtol=1e-6)),
                          (jnp.bfloat16, torch.bfloat16, dict(atol=1e-6, rtol=2 ** -7))):
        jopt, topt = js.make_optimizer(js.OptimConfig(**oc)), ts.Optimizer(ts.OptimConfig(**oc))
        jstate = js.init_state(_jax(_tree_of([(k, v.astype(jdt)) for k, v in p32.items()])), jopt)
        tstate = ts.init_state(_tree_of([(k, t(v, tdt)) for k, v in p32.items()]), topt)
        never = tstate.params["never"].detach().to(torch.float32).clone()
        apply = jit_o0(lambda s, g: js._apply_grads(s, g, jopt))
        for i, g in enumerate(steps):
            jstate, jnorm = apply(jstate, _jax(_tree_of([(k, v.astype(jdt)) for k, v in g.items()])))
            tnorm = ts._apply(tstate, {k: t(v, tdt) for k, v in g.items()}, topt)
            what = f"{tdt} step {i + 1}"
            np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=tol["rtol"], err_msg=what)
            adam = jstate.opt_state[1][0]
            for k, _ in shapes.items():
                for got, want in ((tstate.params, jstate.params), (tstate.opt_state["mu"], adam.mu),
                                  (tstate.opt_state["nu"], adam.nu)):
                    w = flatten_params(jax.tree.map(lambda a: np.asarray(a, np.float32), want))[k]
                    g_ = (got[k] if k in got else flatten_params(got)[k])
                    assert g_.dtype == tdt, (what, k)
                    np.testing.assert_allclose(n(g_.to(torch.float32)), w, **tol,
                                               err_msg=f"{what}: {k}")
        if tdt == torch.float32:
            # no gradient, no moments: each step's update is the decay alone
            want = never
            for _ in steps:
                want = want + (want * 0.1) * -3e-2
            np.testing.assert_allclose(n(tstate.params["never"]), n(want), rtol=1e-6)


def test_training_reaches_no_kernel(monkeypatch):
    from flowmirror_hydravox_tpu_torch.params import from_numpy_tree

    def refuse(*args, **kwargs):
        raise AssertionError("a training forward reached a decode kernel's dispatch")

    monkeypatch.setattr(tq, "decode_mlp", refuse)
    monkeypatch.setattr(tq, "decode_attention_dispatch", refuse)
    leaves = ts.tree_leaves(from_numpy_tree(seeded_tiny_trees()[0], "cpu"))
    for _, p in leaves:
        p.requires_grad_(True)
    batch = _batch(8)
    loss = tl.forward_loss(_tree_of(leaves), CFG, *[t(batch[k]) for k in KEYS])["loss"]
    grads = dict(zip([k for k, _ in leaves],
                     torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)))
    for name in ("gate_proj_w", "up_proj_w", "down_proj_w"):
        g = grads[f"mtp_block.{name}"]
        assert g is not None and bool((g.abs().sum(dim=(1, 2)) > 0).all()), name
    # the kernels have no backward: their wrappers refuse inputs that need one
    x = torch.zeros(2, 16, requires_grad=True)
    w = torch.zeros(16, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        tmlp.mlp_gemv_cuda(x, w, w, w.T.contiguous())
    q = torch.zeros(1, 2, 4, 16, requires_grad=True)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        tda.decode_attention_cuda(q, kv, kv, torch.zeros(1, dtype=torch.int32))
