"""Frontend-extractor training in the port (train/train_frontend.py, the
training half of frontend/speech_tokenizer.py, utils/audio.kaldi_fbank,
train/augment.py) against the JAX package on the CPU.

Inputs are seeded numpy; JAX's initial trees cross into the port through
the npz format. Tolerances:
- `kaldi_fbank` (log power, floored only at 1e-10 at the int16 scale, so a
  clip spans ~220 dB): within FBANK_ATOL in the bins within 60 dB of each
  clip's loudest, within FBANK_QUIET_ATOL in those within 100 dB; below
  that the log reads the two FFTs' f32 rounding (up to ~0.2 apart 120 dB
  down), and the bins are held to being finite. The HTK and Slaney
  filterbanks bit-equal.
- FSQ: lattice values within 1e-6 (no element within 1e-4 of a rounding
  boundary), the straight-through gradient within 1e-6.
- Losses within LOSS_RTOL relative; every leaf's gradient, and Adam's
  moments after one step, within GRAD_TOL of that leaf's largest (the
  moments, not the leaves: Adam's first step scales a tiny gradient to lr).
- Batches, augmentation and the CLI's saved trees: bit-equal.

The configs are the tiny ones of tests/test_train_frontend.py; each JAX
program (a loss, its gradient and one optimizer update per model) is jitted
and compiles once."""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.frontend import speech_tokenizer as jst
from flowmirror_hydravox_tpu.frontend.frontend import Frontend as JaxFrontend
from flowmirror_hydravox_tpu.train import augment as jaug
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu.train import steps as js
from flowmirror_hydravox_tpu.train import train_frontend as jtf
from flowmirror_hydravox_tpu.utils import audio as jaudio
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.frontend import speech_tokenizer as st
from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
from flowmirror_hydravox_tpu_torch.params import flatten_params, load_params_npz
from flowmirror_hydravox_tpu_torch.train import augment, steps, train_frontend
from flowmirror_hydravox_tpu_torch.train.data import Prefetch
from flowmirror_hydravox_tpu_torch.train.synth_speech import synth_utterance
from flowmirror_hydravox_tpu_torch.utils import audio
from flowmirror_hydravox_tpu_torch.utils.wavio import encode_wav
from tests.torch_port_util import jit_o0, n, t

TOK_CFG = jst.SpeechTokenizerConfig(dim=64, num_layers=2, num_heads=4)
SPK_CFG = jst.SpeakerEncoderConfig(dim=32, num_layers=2)
N_SPK = 4
FBANK_ATOL = 1e-3
FBANK_QUIET_ATOL = 1e-2
FBANK_RANGE = float(np.log(1e6))  # 60 dB of power
FBANK_QUIET_RANGE = float(np.log(1e10))  # 100 dB
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(learning_rate=3e-4, warmup_steps=2, total_steps=10)  # make_optimizer's clamp: warmup 2


def _clips(b, seconds, seed):
    """b seeded voiced clips at 16 kHz (formant speech, speakers 5 + i)."""
    return np.stack([synth_utterance(5 + i, seed + i, seconds, seed=seed)
                     for i in range(b)]).astype(np.float32)


def _port_tree(tree, tmp_path, name):
    """A JAX tree carried into the port as the npz the packages share."""
    path = str(tmp_path / f"{name}.npz")
    jckpt.save_params_npz(path, tree)
    return load_params_npz(path, "cpu", torch.float32)


def _adam(opt_state):
    """Adam's state inside an optax state (a chain or adamw alone)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


def _close_to_largest(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _check_tree(got: dict, want_tree, what):
    want = flatten_params(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for k, w in want.items():
        _close_to_largest(got[k], w, GRAD_TOL, f"{what} {k}")


def _jax_step(loss_fn, params, *batch):
    """JAX's train_frontend step (train_frontend.py:254-270) on make_optimizer
    at OPT: (loss, metrics, gradients, the updated optimizer state)."""
    optimizer = js.make_optimizer(js.OptimConfig(**OPT))
    state = js.init_state(params, optimizer)

    @jit_o0
    def step(params, opt_state, *batch):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: loss_fn(p, *batch), has_aux=True)(params)
        _, opt_state = optimizer.update(grads, opt_state, params)
        return loss, metrics, grads, opt_state

    return step(state.params, state.opt_state, *batch)


def _port_step(tree, batch, fn):
    """The port's loss, metrics and gradients of `fn`, then one update of a
    fresh optimizer at OPT. Returns (loss, metrics, {path: grad}, state)."""
    leaves = steps.tree_leaves(tree)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, metrics = fn(tree, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    opt = steps.Optimizer(steps.OptimConfig(**OPT))
    state, _ = steps.loss_train_step(steps.init_state(tree, opt), batch, fn, opt)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {k: g for (k, _), g in zip(leaves, grads)}, state)


@pytest.fixture(scope="module")
def tokenizer_case(tmp_path_factory):
    """One tokenizer batch through JAX's step and the port's, from JAX's
    init; JAX also gives the masked loss and its gradient."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jparams = {"enc": jst.init_tokenizer_params(k1, TOK_CFG),
               "dec": jst.init_decoder_params(k2, TOK_CFG)}
    wavs = _clips(2, 0.5, seed=3)
    mel_len = np.array([48, 30], np.int32)

    def loss_fn(p, w, ml):
        mel = jst.whisper_log_mel(w, n_mels=TOK_CFG.n_mels)
        loss = jst.tokenizer_recon_loss(p["enc"], p["dec"], TOK_CFG, mel)
        masked, masked_grads = jax.value_and_grad(
            lambda q: jst.tokenizer_recon_loss(q["enc"], q["dec"], TOK_CFG, mel, ml))(p)
        return loss, {"masked": masked, "masked_grads": masked_grads}

    jax_out = _jax_step(loss_fn, jparams, jnp.asarray(wavs), jnp.asarray(mel_len))
    tmp = tmp_path_factory.mktemp("tok")
    tree = _port_tree(jparams, tmp, "tok")
    cfg = st.SpeechTokenizerConfig(**{f.name: getattr(TOK_CFG, f.name)
                                      for f in TOK_CFG.__dataclass_fields__.values()})
    port_out = _port_step(tree, {"wavs": t(wavs)}, train_frontend.loss_fn("tokenizer", cfg))
    masked_tree = _port_tree(jparams, tmp, "tok_masked")
    leaves = steps.tree_leaves(masked_tree)
    for _, p in leaves:
        p.requires_grad_(True)
    mel = audio.whisper_log_mel(t(wavs), n_mels=cfg.n_mels)
    masked = st.tokenizer_recon_loss(masked_tree["enc"], masked_tree["dec"], cfg, mel,
                                     t(mel_len))
    masked_grads = torch.autograd.grad(masked, [p for _, p in leaves])
    return jax_out, port_out, (masked.detach(),
                               {k: g for (k, _), g in zip(leaves, masked_grads)})


@pytest.fixture(scope="module")
def speaker_case(tmp_path_factory):
    """One speaker batch (embedding -> AAM softmax) through JAX's step and
    the port's, from JAX's init, on the same kaldi fbank features (JAX's):
    the two FFTs' rounding in bins over 100 dB down (see the module
    docstring) would otherwise set the gradients' differences."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    jparams = {"spk": jst.init_speaker_params(k1, SPK_CFG),
               "classifier": jax.random.normal(k2, (N_SPK, SPK_CFG.embed_dim)) * 0.05}
    wavs = _clips(6, 0.5, seed=11)
    feats = np.asarray(jit_o0(jax.vmap(
        lambda x: jaudio.kaldi_fbank(x, 16000, SPK_CFG.n_mels)))(wavs))
    labels = np.array([0, 1, 2, 3, 1, 2], np.int32)

    def loss_fn(p, f, lab):
        emb = jst.speaker_embedding(p["spk"], SPK_CFG, jnp.swapaxes(f, 1, 2))
        loss, acc = jst.aam_softmax_loss(emb, p["classifier"], lab)
        e = emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)
        c = p["classifier"] / jnp.linalg.norm(p["classifier"], axis=-1, keepdims=True)
        return loss, {"acc": acc, "max_abs_cos": jnp.max(jnp.abs(e @ c.T))}

    jax_out = _jax_step(loss_fn, jparams, jnp.asarray(feats), jnp.asarray(labels))
    tree = _port_tree(jparams, tmp_path_factory.mktemp("spk"), "spk")
    cfg = st.SpeakerEncoderConfig(**{f.name: getattr(SPK_CFG, f.name)
                                     for f in SPK_CFG.__dataclass_fields__.values()})
    port_out = _port_step(tree, {"feats": t(feats), "labels": t(labels)},
                          lambda p, b: train_frontend.speaker_feature_loss(
                              p, cfg, b["feats"], b["labels"]))
    return jax_out, port_out


def test_kaldi_fbank_and_htk_filterbank_match_jax():
    for htk in (False, True):
        for args in ((16000, 512, 80, 20.0), (16000, 400, 128, 0.0), (24000, 1920, 80, 0.0)):
            np.testing.assert_array_equal(audio.mel_filterbank(*args, None, htk),
                                          jaudio.mel_filterbank(*args, None, htk))
    wavs = _clips(4, 1.0, seed=7)
    want = np.asarray(jit_o0(jax.vmap(lambda w: jaudio.kaldi_fbank(w, 16000, 80)))(wavs))
    got = n(audio.kaldi_fbank(t(wavs)))
    assert got.shape == want.shape == (4, 98, 80)
    assert np.isfinite(got).all()
    for g, w in zip(got, want):
        for db_range, atol in ((FBANK_RANGE, FBANK_ATOL), (FBANK_QUIET_RANGE, FBANK_QUIET_ATOL)):
            near = w >= w.max() - db_range
            np.testing.assert_allclose(g[near], w[near], rtol=0, atol=atol)
    short = wavs[0, :300]  # shorter than one 400-sample frame: the last sample repeats
    want_short = jax.jit(jaudio.kaldi_fbank, static_argnums=(1, 2))(jnp.asarray(short), 16000, 40)
    np.testing.assert_allclose(n(audio.kaldi_fbank(t(short), 16000, 40)), np.asarray(want_short),
                               rtol=0, atol=FBANK_ATOL)


def test_fsq_quantize_ste_values_and_gradient():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((2, 5, 8)) * 1.5).astype(np.float32)
    w = rng.standard_normal((2, 5, 8)).astype(np.float32)
    levels = TOK_CFG.fsq_levels
    v = np.tanh(z.astype(np.float64))  # lattice coordinate x (L - 1) / 2 = 1 for L = 3
    assert np.abs(np.abs(v - np.floor(v)) - 0.5).min() > 1e-4
    want_q = np.asarray(jit_o0(lambda x: jst.fsq_quantize_ste(x, levels))(jnp.asarray(z)))
    want, want_grad = jit_o0(jax.value_and_grad(
        lambda x: jnp.sum(jst.fsq_quantize_ste(x, levels) * w)))(jnp.asarray(z))
    zt = t(z).requires_grad_(True)
    q = st.fsq_quantize_ste(zt, levels)
    (grad,) = torch.autograd.grad(torch.sum(q * t(w)), zt)
    np.testing.assert_allclose(n(q), want_q, rtol=0, atol=1e-6)
    assert set(np.unique(n(q))) <= {-1.0, 0.0, 1.0}
    np.testing.assert_allclose(n(grad), np.asarray(want_grad), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(torch.sum(q.detach() * t(w))), float(want), rtol=1e-6)


def test_tokenizer_recon_loss_and_gradients_match_jax(tokenizer_case):
    (jloss, jaux, jgrads, _), (loss, _, grads, _), (masked, masked_grads) = tokenizer_case
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(masked), float(jaux["masked"]), rtol=LOSS_RTOL)
    assert abs(float(masked) - float(loss)) > 1e-6  # the mask drops frames
    _check_tree(grads, jgrads, "gradient")
    _check_tree(masked_grads, jaux["masked_grads"], "masked gradient")


def test_speaker_aam_loss_and_gradients_match_jax(speaker_case):
    (jloss, jaux, jgrads, _), (loss, metrics, grads, _) = speaker_case
    # the batch keeps every cosine well inside arccos's clip, where the two
    # packages' clip gradients differ (exactly at +-(1 - 1e-7))
    assert float(jaux["max_abs_cos"]) < 0.99
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert float(metrics["acc"]) == float(jaux["acc"])
    _check_tree(grads, jgrads, "gradient")


def test_one_step_of_each_model_matches_make_optimizer(tokenizer_case, speaker_case):
    for what, case in (("tokenizer", tokenizer_case), ("speaker", speaker_case)):
        (_, _, jgrads, jopt), (_, _, _, state) = case[:2]
        adam = _adam(jopt)
        assert state.opt_state["count"] == int(adam.count) == 1, what
        assert float(optax.global_norm(jgrads)) > 0
        for name in ("mu", "nu"):
            _check_tree(state.opt_state[name], getattr(adam, name), f"{what} {name}")


def test_augment_is_byte_identical():
    w = _clips(1, 1.0, seed=2)[0]
    for seed in range(6):
        np.testing.assert_array_equal(augment.augment_wav(np.random.default_rng(seed), w),
                                      jaug.augment_wav(np.random.default_rng(seed), w))
    wavs = _clips(4, 0.5, seed=4)
    labels = np.arange(4, dtype=np.int32)
    got = list(augment.augment_batches(iter([(wavs, labels)] * 3), seed=1, prob=0.5))
    want = list(jaug.augment_batches(iter([(wavs, labels)] * 3), seed=1, prob=0.5))
    for (gw, gl), (ww, wl) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gl, wl)


def test_batchers_are_byte_identical_and_a_small_dir_raises(tmp_path):
    def same(got, want):
        for (gw, gl), (ww, wl) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gw, ww)
            assert (gl is None and wl is None) or np.array_equal(gl, wl)

    same(itertools.islice(train_frontend._synthetic_batches(3, 0.25, 4, 9), 3),
         itertools.islice(jtf._synthetic_batches(3, 0.25, 4, 9), 3))
    flat, whole, spk, small = (tmp_path / d for d in ("flat", "whole", "spk", "small"))
    rng = np.random.default_rng(5)
    for i in range(5):  # 16 and 24 kHz clips, one shorter than a crop
        sr = (16000, 24000)[i % 2]
        wav = (rng.standard_normal(int(sr * (0.2 if i == 3 else 0.6))) * 0.1).astype(np.float32)
        for root, keep in ((flat, True), (whole, i < 4), (spk / f"s{i % 2}", True),
                           (small, i == 0)):
            if keep:
                root.mkdir(parents=True, exist_ok=True)
                (root / f"c{i}.wav").write_bytes(encode_wav(wav, sr))
    args = (2, 0.4, 7)
    same(itertools.islice(train_frontend._wav_batches(str(flat), *args), 5),
         itertools.islice(jtf._wav_batches(str(flat), *args), 5))
    # a first epoch that fills its last batch exactly ends the JAX batcher: so the port's
    same(train_frontend._wav_batches(str(whole), *args), jtf._wav_batches(str(whole), *args))
    same(itertools.islice(train_frontend._speaker_batches(str(spk), *args), 5),
         itertools.islice(jtf._speaker_batches(str(spk), *args), 5))
    # one usable clip: JAX's batchers would loop forever without a batch; the
    # trainers' prefetch thread hands the error to the loop
    with pytest.raises(ValueError, match="1 usable clips, fewer than one batch of 2"):
        with Prefetch(train_frontend._wav_batches(str(small), *args)) as batches:
            next(iter(batches))
    (small / "s0").mkdir()
    (small / "c0.wav").rename(small / "s0" / "c0.wav")
    with pytest.raises(ValueError, match="1 usable clips"):
        next(train_frontend._speaker_batches(str(small), *args))


def test_cli_files_load_in_both_frontends(tmp_path, monkeypatch):
    runs = {"tokenizer": ["--batch_size", "2", "--seconds", "0.5"],
            "speaker": ["--batch_size", "4", "--seconds", "0.5", "--n_speakers", "3",
                        "--preset", "shipped"]}
    states = {}
    for model, extra in runs.items():
        out = tmp_path / model
        states[model] = train_frontend.main(
            ["--model", model, "--synthetic", "--tiny", "--output_dir", str(out),
             "--max_steps", "2", "--logging_steps", "1", "--device", "cpu", *extra])
        assert sorted(os.listdir(out)) == sorted(f"{model}{s}" for s in (".json", ".npz",
                                                                         "_full.npz"))
        monkeypatch.setenv(f"HYDRAVOX_{model.upper()}_NPZ", str(out / f"{model}.npz"))
    assert states["tokenizer"].step == states["speaker"].step == 2
    with np.load(tmp_path / "speaker" / "speaker.npz") as f:  # --preset shipped: fp16
        assert {f[k].dtype for k in f.files} == {np.dtype(np.float16)}
    jfe = JaxFrontend(jax_tiny_config())
    fe = Frontend(tiny_config(), device="cpu")
    sidecar = json.loads((tmp_path / "tokenizer" / "tokenizer.json").read_text())
    assert sidecar["dim"] == fe.st_cfg.dim == jfe.st_cfg.dim == 64
    assert fe.spk_cfg.dim == jfe.spk_cfg.dim == 32
    for got_tree, jax_tree, model, key, half in (
            (fe.tokenizer_params, jfe.tokenizer_params, "tokenizer", "enc", False),
            (fe.speaker_params, jfe.speaker_params, "speaker", "spk", True)):
        trained = flatten_params(states[model].params[key])
        got, want = flatten_params(got_tree), flatten_params(jax.tree.map(np.asarray, jax_tree))
        assert set(got) == set(want) == set(trained)
        for k, v in trained.items():
            v = n(v).astype(np.float16).astype(np.float32) if half else n(v)
            np.testing.assert_array_equal(n(got[k]), v)
            np.testing.assert_array_equal(want[k], v)
    wav = _clips(1, 1.0, seed=21)[0]
    _close_to_largest(fe.extract_spk_embedding(wav, 16000),
                      jfe.extract_spk_embedding(wav, 16000), GRAD_TOL, "embedding")
