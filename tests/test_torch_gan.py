"""Vocoder GAN training in the port against the JAX package (CPU, f32): the
full-width discriminators (41.4 M parameters, fixed widths) and the tiny
HiFT of `tiny_config()`. Both packages get the same numpy weights: the
port's seeded draws (the JAX init of the discriminators takes ~12 s on the
CPU), and the HiFT of `seeded_tiny_trees()`. The vocoder's draws are the
JAX key chain's, replayed by `JaxReplayNoise` (a step key, or under
accumulation one key per micro-batch, split at hift.py:228 into the
(rand_ini, noise) draws).

- `discriminator.forward` on a (2, 3840) wav: the 8 scores and 8 lists of
  feature maps within 1e-5 of each tensor's largest magnitude;
- every loss within 1e-6 relative (the multi-resolution mel L1 within
  1e-5, as the log-mels agree), and the gradients of the TPR loss within
  1e-6, at an even and an odd count of scores: the median averages the two
  middle values of an even count, and each takes half the gradient
  (`torch.median` takes the lower one);
- one `gan_train_step` held to one jitted JAX `gan_train_step` at B 1,
  t_mel 8, written as its two halves (gan.py:234-245) so that the program
  also returns the generator half's fake: every metric within 1e-5 relative, the fake within 1e-5, the gradients
  (Adam's first moments, (1 - b1) x the clipped gradient) within 1e-3 of
  each leaf's largest (most agree within 1e-5; a pre-activation within
  rounding of zero, 4.5e-8 in the first spectrogram discriminator here, can
  take leaky_relu's other slope in one package, which moves that
  discriminator's first-layer gradients by up to 2e-4 of their largest,
  and the snake alphas' gradients are sums that cancel to ~1e-6, where the
  two packages part by up to 1e-4), and the parameters after the step within
  1e-6 x (1 + |p|) at lr 1e-5, where an element whose gradient is within
  1e-4 of zero may be 2 lr apart (Adam's first step moves each element by
  about lr x the sign of its gradient);
- accumulation (t_mel 2): the generator half at accum 2 over two different
  micro-batches gives the fakes of two accum 1 runs, one per micro-batch
  with its micro key, and the update of their mean gradient (Adam's first
  moments and the parameters within 1e-6 of each leaf's largest: the same
  f32 sums); the discriminator half at accum 2 on two equal micro-batches
  gives its accum 1 update (within 1e-6), and on the accumulated fakes is
  held to one jitted JAX `gan_disc_step` at accum 2 (loss and grad norm
  within 1e-5 relative, parameters as above); a batch without pitch_feat
  gives an f0 term of a float32 zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.models import discriminator as jdisc
from flowmirror_hydravox_tpu.train import gan as jgan
from flowmirror_hydravox_tpu.train import steps as js
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.models import discriminator as tdisc
from flowmirror_hydravox_tpu_torch.models import hift as thift
from flowmirror_hydravox_tpu_torch.params import (flatten_params, from_numpy_tree,
                                                  init_disc_params)
from flowmirror_hydravox_tpu_torch.train import gan as tgan
from flowmirror_hydravox_tpu_torch.train import steps as ts
from tests.torch_port_util import JaxReplayNoise, n, seeded_tiny_trees, t

CFG = tiny_config().hift
JCFG = jax_tiny_config().hift
T_MEL = 8
OPTIM = dict(learning_rate=1e-5, warmup_steps=1, total_steps=10, schedule="constant",
             weight_decay=0.0, b1=0.8, b2=0.99)  # train_hift's AdamW at a small lr


@functools.lru_cache(maxsize=None)
def disc_tree():
    """The discriminators' weights as numpy (the port's seeded init)."""
    tree = init_disc_params(torch.Generator().manual_seed(5), "cpu")
    return jax.tree.map(lambda a: a.numpy(), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(seed, b, t_mel=T_MEL):
    rng = np.random.default_rng(seed)
    return {"speech_feat": (rng.standard_normal((b, t_mel, 80)) * 0.3 - 4.0).astype(np.float32),
            "speech": (rng.standard_normal((b, t_mel * CFG.upsample_scale)) * 0.1).astype(
                np.float32),
            "pitch_feat": (np.abs(rng.standard_normal((b, t_mel))) * 100).astype(np.float32)}


def _close_to_largest(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _mu(opt_state):
    """The first moments of an optax clip + adamw state, flattened by path."""
    (adam, *_), = [s for s in opt_state if isinstance(s, tuple) and s]
    return flatten_params(jax.tree.map(np.asarray, adam.mu))


def _params_close(got_tree, jstate, what):
    """Parameters after one step within 1e-6 x (1 + |p|), but for Adam's sign
    flips: the first step moves an element by about lr x sign(gradient), so
    where the gradient lies within rounding of zero (1e-4 of its leaf's
    largest here) the two packages may move it apart by up to 2 lr."""
    want = flatten_params(jax.tree.map(np.asarray, jstate.params))
    mu = _mu(jstate.opt_state)
    got = flatten_params(got_tree)
    assert set(got) == set(want), what
    for k, w in want.items():
        err = np.abs(n(got[k]) - w)
        off = err > 1e-6 * (1 + np.abs(w))
        flip = (np.abs(mu[k]) <= 1e-4 * np.abs(mu[k]).max()) & (err <= 2.5 * OPTIM["learning_rate"])
        assert not (off & ~flip).any(), (what, k, err[off & ~flip][:5])


def test_discriminator_forward_matches_jax():
    wav = (np.random.default_rng(1).standard_normal((2, 3840)) * 0.1).astype(np.float32)
    want_s, want_f = jax.jit(jdisc.forward)(_jax(disc_tree()), jnp.asarray(wav))
    got_s, got_f = tdisc.forward(from_numpy_tree(disc_tree(), "cpu"), t(wav))
    assert len(got_s) == len(want_s) == 8 and len(got_f) == 8
    for i, (gs, ws, gf, wf) in enumerate(zip(got_s, want_s, got_f, want_f)):
        assert gs.shape == ws.shape, (i, gs.shape, ws.shape)
        _close_to_largest(gs, ws, 1e-5, f"score {i}")
        assert len(gf) == len(wf) == 6
        for j, (g, w) in enumerate(zip(gf, wf)):
            assert g.shape == w.shape, (i, j, g.shape, w.shape)
            _close_to_largest(g, w, 1e-5, f"fmap {i}.{j}")


def test_gan_losses_match_jax():
    rng = np.random.default_rng(2)
    # 12 and 7 scores: an even count (two middle values) and an odd one
    shapes = [(2, 6), (1, 7)]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    fake = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    fmaps_r = [[rng.standard_normal((1, 2, 3, 4)).astype(np.float32) for _ in range(2)]]
    fmaps_f = [[rng.standard_normal((1, 2, 3, 4)).astype(np.float32) for _ in range(2)]]
    wav = (rng.standard_normal((2, 4800)) * 0.1).astype(np.float32)
    tau = 1.0  # above every l_rel here, so the TPR term and its gradient are not clipped

    def losses(mod, real, fake, fr, ff, wr, wf):
        return {"disc": mod.discriminator_loss(real, fake),
                "adv": mod.generator_adv_loss(fake), "fm": mod.feature_loss(fr, ff),
                "tpr": mod.tpr_loss(real, fake, tau), "mel": mod.multi_mel_loss(wr, wf, 24000)}

    @jax.jit
    def reference(real, fake, fr, ff, wr, wf):
        return (losses(jgan, real, fake, fr, ff, wr, wf),
                jax.grad(lambda f: jgan.tpr_loss(real, f, tau))(fake))

    want, want_g = reference(*(_jax(x) for x in (real, fake, fmaps_r, fmaps_f, wav, wav * 0.5)))
    tfake = [t(f).requires_grad_(True) for f in fake]
    got = losses(tgan, [t(r) for r in real], tfake, [[t(a) for a in fr] for fr in fmaps_r],
                 [[t(a) for a in ff] for ff in fmaps_f], t(wav), t(wav * 0.5))
    for k, w in want.items():
        # the log-mels agree within 1e-5 (tests/test_torch_audio.py), the rest to rounding
        np.testing.assert_allclose(float(got[k].detach()), float(w),
                                   rtol=1e-5 if k == "mel" else 1e-6, err_msg=k)
    assert float(got["tpr"].detach()) < tau * len(shapes)
    got_g = torch.autograd.grad(got["tpr"], tfake)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    # the even count's median is the mean of its two middle values
    diff = real[0] - fake[0]
    assert float(tgan.median(t(diff))) == pytest.approx(float(np.median(diff)), abs=1e-7)
    assert float(tgan.median(t(diff))) != float(torch.median(t(diff)))


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX gan_train_step from the seeded trees, and the fake its
    generator half hands to the discriminator half."""
    jopt = js.make_optimizer(js.OptimConfig(**OPTIM))
    gen, disc = _jax(seeded_tiny_trees()[2]), _jax(disc_tree())
    batch = _batch(3, 1)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def run(gs, ds, b, rng):
        # gan_train_step's body: the two halves in its order, one program
        gs, fake, gm = jgan.gan_gen_step(gs, ds.params, b, rng, JCFG, jopt)
        ds, dm = jgan.gan_disc_step(ds, b["speech"], fake, jopt)
        return gs, ds, {**gm, **dm}, fake

    gs, ds, metrics, fake = run(js.init_state(gen, jopt), js.init_state(disc, jopt),
                                _jax(batch), key)
    return batch, key, gs, ds, metrics, fake


def test_gan_train_step_matches_jax(jax_step):
    batch, key, jgs, jds, jm, jfake = jax_step
    opt = ts.Optimizer(ts.OptimConfig(**OPTIM))
    gs = ts.init_state(from_numpy_tree(seeded_tiny_trees()[2], "cpu"), opt)
    ds = ts.init_state(from_numpy_tree(disc_tree(), "cpu"), opt)
    tb = ts.batch_to(batch, "cpu")
    with torch.no_grad():  # the fake of the step's generator forward
        fake = thift.inference(gs.params, CFG, tb["speech_feat"].transpose(1, 2),
                               JaxReplayNoise(key))
    gs, ds, tm = tgan.gan_train_step(gs, ds, tb, JaxReplayNoise(key), CFG, opt, opt)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(n(fake), np.asarray(jfake), rtol=0, atol=1e-5)
    for what, state, jstate in (("gen", gs, jgs), ("disc", ds, jds)):
        want_mu = _mu(jstate.opt_state)
        assert set(state.opt_state["mu"]) == set(want_mu), what
        for k, w in want_mu.items():
            _close_to_largest(state.opt_state["mu"][k], w, 1e-3, f"{what} mu {k}")
        _params_close(state.params, jstate, what)
    assert gs.step == ds.step == 1


def test_gan_grad_accum_duplicated_micro_batches():
    """The generator half at accum 2 over two different micro-batches: the
    fakes of two accum 1 runs, one per micro-batch with its micro key, and
    the update of their mean gradient. The discriminators' update at accum 2
    on two equal micro-batches equals the unaccumulated one (identical micro
    losses, TPR's median per micro-batch); the disc half at accum 2 on the
    accumulated fakes equals JAX's. The accumulated generator half runs
    without pitch_feat."""
    opt = ts.Optimizer(ts.OptimConfig(**OPTIM))
    t_mel = 2  # 960 samples: the JAX accumulated step runs its scan slowly on the CPU
    micros = [_batch(4, 2, t_mel), _batch(5, 2, t_mel)]
    batch = {k: np.concatenate([m[k] for m in micros]) for k in micros[0]}
    key = jax.random.PRNGKey(8)
    disc = from_numpy_tree(disc_tree(), "cpu")

    def gen_state():
        return ts.init_state(from_numpy_tree(seeded_tiny_trees()[2], "cpu"), opt)

    # the accumulated run without pitch_feat: its f0 term is a float32 zero,
    # summed over the micro-batches like the other parts
    nopitch = {k: v for k, v in batch.items() if k != "pitch_feat"}
    gs_acc, fake_acc, gm = tgan.gan_gen_step(gen_state(), disc, ts.batch_to(nopitch, "cpu"),
                                             JaxReplayNoise(key), CFG, opt, accum_steps=2)
    assert gm["f0"].dtype == torch.float32 and float(gm["f0"]) == 0.0
    assert fake_acc.shape == (4, t_mel * CFG.upsample_scale)
    assert np.isfinite(float(gm["gen_loss"]))

    # each micro-batch alone with its micro key, then one update on the mean
    ref, fakes, grads = gen_state(), [], []
    for mb, mkey in zip(micros, jax.random.split(key, 2)):
        mb = ts.batch_to({k: v for k, v in mb.items() if k != "pitch_feat"}, "cpu")
        _, _, g = ts._value_and_grad_accum(tgan.gen_loss_fn(disc, CFG, fakes=fakes),
                                           ref.params, mb, 1, JaxReplayNoise(mkey))
        grads.append(g)
    np.testing.assert_allclose(n(fake_acc), n(torch.cat(fakes)), rtol=0, atol=1e-6)
    assert not np.allclose(n(fakes[0]), n(fakes[1]), atol=1e-3)  # their own rows and draws
    gnorm = ts._apply(ref, {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}, opt)
    np.testing.assert_allclose(float(gm["gen_grad_norm"]), float(gnorm), rtol=1e-6)
    for k, p in flatten_params(ref.params).items():
        _close_to_largest(gs_acc.opt_state["mu"][k], n(ref.opt_state["mu"][k]), 1e-6, f"mu {k}")
        _close_to_largest(flatten_params(gs_acc.params)[k], n(p), 1e-6, f"param {k}")

    def gan_disc(real, fake, **kw):
        state = ts.init_state(from_numpy_tree(disc_tree(), "cpu"), opt)
        return tgan.gan_disc_step(state, real, fake, opt, **kw)

    # micro-batches of one row: the first row of the first micro-batch, twice
    real2 = t(np.concatenate([micros[0]["speech"][:1]] * 2))
    fake2 = torch.cat([fakes[0][:1], fakes[0][:1]])
    d_acc, dm_acc = gan_disc(real2, fake2, accum_steps=2)
    d_one, dm_one = gan_disc(real2, fake2)
    np.testing.assert_allclose(float(dm_acc["disc_loss"]), float(dm_one["disc_loss"]), rtol=1e-6)
    for k, p in flatten_params(d_one.params).items():
        np.testing.assert_allclose(n(flatten_params(d_acc.params)[k]), n(p), rtol=0, atol=1e-6,
                                   err_msg=k)

    # the disc half as train_hift runs it, on the accumulated generator's
    # fakes (its two micro-batches differ), against JAX's
    d_acc, dm_acc = gan_disc(t(batch["speech"]), fake_acc, accum_steps=2)
    jopt = js.make_optimizer(js.OptimConfig(**OPTIM))
    jd, jdm = jax.jit(lambda s, r, f: jgan.gan_disc_step(s, r, f, jopt, accum_steps=2))(
        js.init_state(_jax(disc_tree()), jopt), jnp.asarray(batch["speech"]),
        jnp.asarray(n(fake_acc)))
    for k in jdm:
        np.testing.assert_allclose(float(dm_acc[k]), float(jdm[k]), rtol=1e-5, err_msg=k)
    _params_close(d_acc.params, jd, "disc accum 2")
