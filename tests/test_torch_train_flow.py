"""Flow (CFM) training in the port against the JAX package (tiny config,
CPU, f32, the port's seeded flow tree from `seeded_tiny_trees()` fed to both;
every draw replayed from the JAX key chain by `JaxReplayNoise.flow_loss`):

- the DiT forward with train-time dropout (the keep masks of
  `dit.py:80` replayed) within 1e-5;
- `compute_loss` with dropout on, rows with and without a mel-prefix
  condition and with their conditions dropped: loss within 1e-5 relative,
  every leaf's gradient within 1e-4 of its largest magnitude;
- two `flow_train_step`s: params within 1e-5 + 1e-4 |p| (learning rate
  1e-4, as tests/test_torch_train_llm.py explains), metrics likewise, and
  `rand_noise`, whose gradient the step zeroes, shrunk by 1 - lr * wd a
  step by the decay alone, as optax shrinks it;
- `accum_steps` 2 with the key split per micro-batch;
- `TorchNoise.flow_loss`: shapes, dtypes, keep rates, `split`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.models import dit as jdit
from flowmirror_hydravox_tpu.models import flow as jflow
from flowmirror_hydravox_tpu.train import steps as js
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.models import dit as tdit
from flowmirror_hydravox_tpu_torch.models import flow as tflow
from flowmirror_hydravox_tpu_torch.noise import TorchNoise
from flowmirror_hydravox_tpu_torch.params import flatten_params, from_numpy_tree, unflatten_params
from flowmirror_hydravox_tpu_torch.train import steps as ts
from tests.torch_port_util import JaxReplayNoise, jit_o0, n, seeded_tiny_trees, t

CFG = tiny_config().flow
JCFG = jax_tiny_config().flow
KEYS = ("speech_token", "token_len", "speech_feat", "feat_len", "embedding")
OPTIM = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10, schedule="constant",
             weight_decay=0.1)


def _batch(seed, b=4, lt=8, token_len=(8, 5, 6, 8)):
    rng = np.random.default_rng(seed)
    tl = np.array(token_len[:b], np.int32)
    return {"speech_token": rng.integers(0, CFG.vocab_size, (b, lt)).astype(np.int32),
            "token_len": tl,
            "speech_feat": rng.standard_normal((b, 2 * lt, 80)).astype(np.float32),
            "feat_len": 2 * tl,
            "embedding": rng.standard_normal((b, 192)).astype(np.float32)}


def _tree():
    return seeded_tiny_trees()[1]


def test_dit_forward_with_dropout_matches_jax():
    est = _tree()["estimator"]
    ecfg = CFG.estimator
    rng = np.random.default_rng(1)
    b, tm = 3, 20
    x, mu, cond = (rng.standard_normal((b, d, tm)).astype(np.float32)
                   for d in (80, ecfg.mu_dim, 80))
    mask = (np.arange(tm)[None, None, :] < np.array([20, 13, 7])[:, None, None]).astype(np.float32)
    tt = rng.uniform(size=(b,)).astype(np.float32)
    spks = rng.standard_normal((b, 80)).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def reference(params, key, *args):
        out = jdit.forward(params, JCFG.estimator, *args, dropout_rng=key, dropout_rate=0.1)
        # the keep masks as dit.py:270 and :202 draw them from dropout_rng
        masks = []
        for blk in jax.random.split(key, ecfg.depth):
            k1, k2 = jax.random.split(blk)
            masks.append((jax.random.bernoulli(k1, 0.9, (b, tm, ecfg.dim)),
                          jax.random.bernoulli(k2, 0.9, (b, tm, ecfg.dim * ecfg.ff_mult))))
        return out, masks

    want, jmasks = jit_o0(reference)(jax.tree.map(jnp.asarray, est), key, *map(jnp.asarray, (
        x, mask, mu, tt, spks, cond)))
    masks = [tuple(t(np.asarray(m)) for m in pair) for pair in jmasks]
    got = tdit.forward(from_numpy_tree(est, "cpu"), ecfg, *map(t, (x, mask, mu, tt, spks, cond)),
                       dropout_masks=masks, dropout_rate=0.1)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    plain = tdit.forward(from_numpy_tree(est, "cpu"), ecfg, *map(t, (x, mask, mu, tt, spks, cond)))
    assert not np.allclose(n(plain), n(got), atol=1e-3)


def test_compute_loss_and_gradients_match_jax():
    batch = _batch(2)
    key = jax.random.PRNGKey(3)
    draws = JaxReplayNoise(key).flow_loss(4, 16, 80, CFG.estimator.depth,
                                          (CFG.estimator.dim, 2 * CFG.estimator.dim), 0.1)
    use_cond = n(draws.cond) >= 0.5
    kept = n(draws.cfg) > CFG.training_cfg_rate
    assert use_cond.any() and not use_cond.all() and kept.any() and not kept.all(), (use_cond, kept)

    jb = [jnp.asarray(batch[k]) for k in KEYS]
    want_loss, want = jit_o0(jax.value_and_grad(
        lambda p: jflow.compute_loss(p, JCFG, key, *jb)))(jax.tree.map(jnp.asarray, _tree()))
    want = flatten_params(jax.tree.map(np.asarray, want))
    leaves = ts.tree_leaves(from_numpy_tree(_tree(), "cpu"))
    for _, p in leaves:
        p.requires_grad_(True)
    loss = tflow.compute_loss(unflatten_params(dict(leaves)), CFG, JaxReplayNoise(key),
                              *[t(batch[k]) for k in KEYS])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
    for (k, _), g in zip(leaves, grads):
        w = want[k]
        got = np.zeros_like(w) if g is None else n(g)
        np.testing.assert_allclose(got, w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=0,
                                   err_msg=k)


def _steps(accum, keys, batch):
    jopt = js.make_optimizer(js.OptimConfig(**OPTIM))
    topt = ts.Optimizer(ts.OptimConfig(**OPTIM))
    jstate = js.init_state(jax.tree.map(jnp.asarray, _tree()), jopt)
    tstate = ts.init_state(from_numpy_tree(_tree(), "cpu"), topt)
    step = jit_o0(lambda s, b, r: js.flow_train_step(s, b, r, JCFG, jopt, accum_steps=accum))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = ts.batch_to(batch, "cpu")
    for i, key in enumerate(keys):
        jstate, jm = step(jstate, jb, key)
        tstate, tm = ts.flow_train_step(tstate, tb, JaxReplayNoise(key), CFG, topt,
                                        accum_steps=accum)
        what = f"accum {accum} step {i + 1}"
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{what}: {k}")
        want = flatten_params(jax.tree.map(np.asarray, jstate.params))
        got = flatten_params(tstate.params)
        for k, w in want.items():
            np.testing.assert_allclose(n(got[k]), w, atol=1e-5, rtol=1e-4, err_msg=f"{what}: {k}")
    return jstate, tstate


def test_flow_train_steps_match_jax_and_decay_rand_noise():
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jstate, tstate = _steps(1, keys, _batch(5))
    # rand_noise gets no gradient, so no moments: the decay alone moves it
    want = t(_tree()["rand_noise"])
    for _ in keys:
        want = want + (want * OPTIM["weight_decay"]) * -OPTIM["learning_rate"]
    got = tstate.params["rand_noise"].detach()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(n(got), np.asarray(jstate.params["rand_noise"]))
    assert not tstate.opt_state["mu"]["rand_noise"].any()
    ratio = float(got[0, 0, 0] / t(_tree()["rand_noise"])[0, 0, 0])
    np.testing.assert_allclose(ratio, (1 - 1e-4 * 0.1) ** 2, rtol=1e-6)


def test_flow_grad_accum_splits_the_key_per_micro_batch():
    _steps(2, [jax.random.PRNGKey(11)], _batch(6))


def test_torch_noise_flow_draws():
    gen = torch.Generator().manual_seed(0)
    noise = TorchNoise(gen)
    d = noise.flow_loss(3, 40, 80, 2, (16, 32), 0.1)
    assert d.t.shape == (3, 1, 1) and d.z.shape == (3, 80, 40)
    assert all(u.shape == (3,) and u.dtype == torch.float32 for u in (d.cfg, d.cond, d.idx))
    assert len(d.keep) == 2 and [m.shape for m in d.keep[0]] == [(3, 40, 16), (3, 40, 32)]
    assert d.keep[0][0].dtype == torch.bool
    rate = float(torch.cat([m.flatten() for pair in d.keep for m in pair]).float().mean())
    assert abs(rate - 0.9) < 0.02, rate
    assert noise.flow_loss(3, 40, 80, 2, (16, 32), 0.0).keep is None
    # micro-batches draw one after another from the one generator
    a, b = noise.split(2)
    assert a is noise and b is noise
    again = TorchNoise(torch.Generator().manual_seed(0)).flow_loss(3, 40, 80, 2, (16, 32), 0.1)
    assert torch.equal(again.z, d.z) and torch.equal(again.keep[1][1], d.keep[1][1])
