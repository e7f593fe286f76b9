"""VAD and ASR training in the port (preprocess/vad_model.bce_loss,
asr_model.ctc_loss, train/train_vad.py, train/train_asr.py) and the two
frontend tools (tools/make_demo_samples.py, eval_frontend_real.py)
against the JAX package on the CPU.

Inputs are seeded numpy; JAX's initial trees cross into the port through
the npz format. Tolerances:
- losses and aux values within LOSS_RTOL relative; every leaf's gradient
  (for the VAD on a batch whose ReLU inputs all lie RELU_MARGIN or more from
  0, so that the two packages' f32 forwards take the same ReLU branches:
  one flip at 4e-7 moved JAX's first-layer gradients by 1-4% of their
  largest, where the port's agreed with a float64 reference to 1e-6),
  and Adam's moments after one step of the trainers' optimizers against
  JAX's optax chains, within GRAD_TOL of that leaf's largest (moments, not
  leaves: Adam's first step scales a tiny gradient to lr);
- the batch builders, the demo samples and the saved trees: bit-equal;
- the trained VAD's probabilities through both loaders within VAD_ATOL;
- eval_frontend_real's cosine figures within COS_ATOL (JAX rounds them to
  3 decimals, and the two packages' embeddings differ in their last bits),
  its counts and token figures equal.

The ASR runs at a narrow config (d 32, 2 heads, 1 block) and both trainers'
pools are cut to a few clips (the CLIs' defaults synthesize 768); each JAX
program is jitted and compiles once."""

import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from flowmirror_hydravox_tpu.preprocess import asr_model as jasr
from flowmirror_hydravox_tpu.preprocess import vad_model as jvad
from flowmirror_hydravox_tpu.tools import eval_frontend_real as jeval
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu.train import train_asr as jtrain_asr
from flowmirror_hydravox_tpu.train import train_vad as jtrain_vad
from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.params import flatten_params, load_params_npz
from flowmirror_hydravox_tpu_torch.preprocess import asr_model, vad_model
from flowmirror_hydravox_tpu_torch.tools import eval_frontend_real, make_demo_samples
from flowmirror_hydravox_tpu_torch.train import steps, train_asr, train_vad
from flowmirror_hydravox_tpu_torch.train.synth_speech import (FRIC_SYMBOLS, VOWEL_SYMBOLS,
                                                              synth_noise, synth_utterance)
from flowmirror_hydravox_tpu_torch.utils import hf_dataset
from tests.torch_port_util import n, t

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
VAD_ATOL = 1e-5
COS_ATOL = 2e-3
RELU_MARGIN = 5e-5  # ~5x the packages' largest logit difference on this batch
ASR_CFG = jasr.ASRModelConfig(d_model=32, num_heads=2, num_layers=1, vocab_size=6)
MAX_STEPS = 50  # the optimizers' schedules: VAD warmup 5, ASR warmup 5
VOCAB = list(VOWEL_SYMBOLS) + list(FRIC_SYMBOLS)
SMALL_POOLS = dict(speech_pool=8, noise_pool=2)


def _port_tree(tree, tmp_path, name):
    """A JAX tree carried into the port as the npz the packages share."""
    path = str(tmp_path / f"{name}.npz")
    jckpt.save_params_npz(path, tree)
    return load_params_npz(path, "cpu", torch.float32)


def _close_to_largest(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _check_tree(got: dict, want_tree, what):
    want = flatten_params(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for k, w in want.items():
        _close_to_largest(got[k], w, GRAD_TOL, f"{what} {k}")


def _adam(opt_state):
    """Adam's state inside an optax state (a chain or adamw alone)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam(s)
        if found is not None:
            return found
    return None


def _case(jparams, jax_opt, jax_loss, port_opt, port_loss, batch, tmp_path):
    """(JAX: loss, aux, grads, optimizer state after one update, global
    norm; port: loss, aux, {path: grad}, state after one update)."""
    @jax.jit
    def step(params, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(lambda p: jax_loss(p, batch), has_aux=True)(
            params)
        _, opt_state = jax_opt.update(grads, opt_state, params)
        return loss, aux, grads, opt_state, optax.global_norm(grads)

    jax_out = step(jparams, jax_opt.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tree = _port_tree(jparams, tmp_path, "tree")
    leaves = steps.tree_leaves(tree)
    for _, p in leaves:
        p.requires_grad_(True)
    tbatch = {k: t(v) for k, v in batch.items()}
    loss, aux = port_loss(tree, tbatch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    state, _ = steps.loss_train_step(steps.init_state(tree, port_opt), tbatch, port_loss,
                                     port_opt)
    return jax_out, (loss, aux, {k: g for (k, _), g in zip(leaves, grads)}, state)


def _noisy_clips(b, seconds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        w = synth_utterance(40 + i, seed + i, seconds, seed=seed)
        out.append(w + 0.05 * synth_noise(("white", "pink")[i % 2], len(w), rng))
    return np.stack(out).astype(np.float32)


def _relu_margin(tree, wavs) -> float:
    """The least |input| of the port's VAD ReLUs on `wavs`."""
    cfg = vad_model.VADModelConfig()
    with torch.no_grad():
        mel = vad_model.mel_spectrogram(t(wavs), 400, cfg.n_mels, 16000, 160, 400)
        x = (mel - mel.mean(-1, keepdim=True)) / torch.sqrt(
            mel.var(-1, unbiased=False, keepdim=True) + 1e-5)
        least = np.inf
        for conv, d in zip(tree["convs"], cfg.dilations):
            z = F.conv1d(x, conv["w"], conv["b"], padding=d, dilation=d)
            least, x = min(least, float(z.abs().min())), F.relu(z)
    return least


@pytest.fixture(scope="module")
def vad_case(tmp_path_factory):
    cfg = jvad.VADModelConfig()
    jparams = jvad.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(1)
    batch = {"wavs": _noisy_clips(3, 1.0, seed=7),
             "labels": (rng.random((3, 104)) < 0.6).astype(np.uint8)}  # 4 frames past the logits'
    jax_opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 5, MAX_STEPS))

    def port_loss(p, b):
        loss, acc = vad_model.bce_loss(p, vad_model.VADModelConfig(), b["wavs"], b["labels"])
        return loss, {"acc": acc}

    tmp = tmp_path_factory.mktemp("vad")
    assert _relu_margin(_port_tree(jparams, tmp, "margin"), batch["wavs"]) >= RELU_MARGIN
    return _case(jparams, jax_opt,
                 lambda p, b: jvad.bce_loss(p, cfg, b["wavs"], b["labels"]),
                 train_vad.optimizer(1e-3, MAX_STEPS), port_loss, batch, tmp)


def _ctc_batch(wav_len, labels, label_len, seconds=1.0, seed=5):
    return {"wavs": _noisy_clips(len(wav_len), seconds, seed),
            "wav_len": np.asarray(wav_len, np.int32), "labels": np.asarray(labels, np.int32),
            "label_len": np.asarray(label_len, np.int32)}


# rows: repeats in the labels; label_len 0; a short wav_len (6000 samples: 8
# of 25 frames); labels padded with junk past label_len
CTC_BATCH = _ctc_batch(
    wav_len=[16000, 16000, 6000, 16000],
    labels=[[1, 2, 2, 3, 0, 0], [0, 0, 0, 0, 0, 0], [5, 4, 5, 0, 0, 0], [3, 1, 4, 5, 2, 1]],
    label_len=[4, 0, 3, 2])


def _port_ctc(p, b):
    loss, emit = asr_model.ctc_loss(p, asr_model.ASRModelConfig(**ASR_CFG.__dict__),
                                    b["wavs"], b["wav_len"], b["labels"], b["label_len"])
    return loss, {"emit_frac": emit}


@pytest.fixture(scope="module")
def asr_case(tmp_path_factory):
    jparams = jasr.init_params(jax.random.PRNGKey(4), ASR_CFG)
    jax_opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 2e-3, 5, MAX_STEPS)))
    return _case(jparams, jax_opt,
                 lambda p, b: jasr.ctc_loss(p, ASR_CFG, b["wavs"], b["wav_len"], b["labels"],
                                            b["label_len"]),
                 train_asr.optimizer(2e-3, MAX_STEPS), _port_ctc, CTC_BATCH,
                 tmp_path_factory.mktemp("asr"))


def test_bce_loss_matches_jax(vad_case):
    (jloss, jacc, jgrads, _, _), (loss, aux, grads, _) = vad_case
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["acc"]), float(jacc), rtol=LOSS_RTOL)
    _check_tree(grads, jgrads, "gradient")


def test_ctc_loss_matches_jax(asr_case, tmp_path):
    (jloss, jemit, jgrads, _, _), (loss, aux, grads, _) = asr_case
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["emit_frac"]), float(jemit), rtol=LOSS_RTOL)
    _check_tree(grads, jgrads, "gradient")
    # a row no path can emit (30 labels in 25 frames) adds 0 and no gradient
    # in the port (optax would add ~1e5 / 30): the mean over 5 rows is 4/5 of
    # the feasible rows'
    tree = _port_tree(jasr.init_params(jax.random.PRNGKey(4), ASR_CFG), tmp_path, "asr")
    labels = np.zeros((5, 30), np.int32)
    labels[:4, :6], labels[4] = CTC_BATCH["labels"], 1 + np.arange(30) % 5
    five = {k: t(v) for k, v in _ctc_batch([16000, 16000, 6000, 16000, 16000], labels,
                                           [4, 0, 3, 2, 30]).items()}
    with torch.no_grad():
        got, _ = _port_ctc(tree, five)
    np.testing.assert_allclose(float(got) * 5, float(loss) * 4, rtol=LOSS_RTOL)


def test_one_asr_and_one_vad_step_match_optax(vad_case, asr_case):
    for what, case in (("vad", vad_case), ("asr", asr_case)):
        (_, _, _, jopt, gnorm), (_, _, _, state) = case
        adam = _adam(jopt)
        assert state.opt_state["count"] == int(adam.count) == 1, what
        if what == "asr":
            assert float(gnorm) > 1.0  # the clip engages
        for name in ("mu", "nu"):
            _check_tree(state.opt_state[name], getattr(adam, name), f"{what} {name}")


def test_batch_builders_are_byte_identical():
    def same(got, want):
        for g, w in zip(got, want, strict=True):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, b)

    same(itertools.islice(train_vad.mixture_batches(4, 1.0, 7, **SMALL_POOLS), 3),
         itertools.islice(jtrain_vad.mixture_batches(4, 1.0, 7, **SMALL_POOLS), 3))
    pools = dict(pool=SMALL_POOLS["speech_pool"], noise_pool=SMALL_POOLS["noise_pool"])
    got, want = (m.synthetic_pool(2.0, 7, VOCAB, **pools) for m in (train_asr, jtrain_asr))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    same(itertools.islice(train_asr.synthetic_batches(4, 2.0, 7, VOCAB, **pools), 3),
         itertools.islice(jtrain_asr.synthetic_batches(4, 2.0, 7, VOCAB, **pools), 3))


def test_dataset_batches_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    rows = []
    for i, (text, sr, sec) in enumerate((("abc ab", 16000, 0.8), ("bca", 24000, 0.5),
                                         ("too long audio", 16000, 1.5), ("", 16000, 0.3),
                                         ("x" * 30, 16000, 0.9), ("cab c", 22050, 0.7))):
        rows.append({"text": text, "audio": {
            "array": (rng.standard_normal(int(sr * sec)) * 0.1).astype(np.float32),
            "sampling_rate": sr}})
    hf_dataset.save_to_disk(rows, str(tmp_path / "ds"))
    for sep in ("", " "):
        args = (str(tmp_path / "ds"), 3, 1.0, 4, sep, 20)
        (got_vocab, got), (want_vocab, want) = (m.dataset_batches(*args)
                                                for m in (train_asr, jtrain_asr))
        assert got_vocab == want_vocab
        for g, w in zip(itertools.islice(got, 3), itertools.islice(want, 3)):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="no usable rows"):
        train_asr.dataset_batches(str(tmp_path / "ds"), 3, 0.1, 4, "", 20)


def test_clis_write_checkpoints_both_packages_load(tmp_path):
    common = ["--batch_size", "4", "--max_steps", "2", "--logging_steps", "1", "--device", "cpu",
              "--noise_pool", str(SMALL_POOLS["noise_pool"])]
    vad_state = train_vad.main(["--output_dir", str(tmp_path / "vad"), "--seconds", "1",
                                "--speech_pool", str(SMALL_POOLS["speech_pool"]), *common])
    asr_state = train_asr.main(["--output_dir", str(tmp_path / "asr"), "--seconds", "2",
                                "--pool", str(SMALL_POOLS["speech_pool"]), *common])
    assert vad_state.step == asr_state.step == 2
    vad_path, asr_path = str(tmp_path / "vad" / "vad.npz"), str(tmp_path / "asr" / "asr.npz")
    jax_vad, port_vad = jvad.NativeVAD(vad_path), vad_model.NativeVAD(vad_path, device="cpu")
    jax_asr, port_asr = jasr.NativeASR(asr_path), asr_model.NativeASR(asr_path, device="cpu")
    assert port_asr.vocab == jax_asr.vocab == VOCAB
    for state, port_tree, jax_tree in ((vad_state, port_vad.params, jax_vad.params),
                                       (asr_state, port_asr.params, jax_asr.params)):
        got, want = flatten_params(port_tree), flatten_params(jax.tree.map(np.asarray, jax_tree))
        trained = {k: n(v).astype(np.float16).astype(np.float32)
                   for k, v in flatten_params(state.params).items()}
        assert set(got) == set(want) == set(trained)
        for k, v in trained.items():
            np.testing.assert_array_equal(n(got[k]), v)
            np.testing.assert_array_equal(want[k], v)
    clip = _noisy_clips(1, 1.0, seed=9)[0]
    np.testing.assert_allclose(port_vad(clip, 16000), np.asarray(jax_vad(clip, 16000)),
                               rtol=0, atol=VAD_ATOL)
    assert port_asr(clip, 16000) == jax_asr(clip, 16000)


def test_make_demo_samples_is_byte_identical(tmp_path):
    written = make_demo_samples.generate(str(tmp_path))
    assert len(written) == 4
    committed = ROOT / "assets" / "samples"
    files = sorted(p.relative_to(committed) for p in committed.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / rel).read_bytes() == (committed / rel).read_bytes(), rel


def test_eval_frontend_real_matches_jax(tmp_path):
    samples = str(ROOT / "assets" / "samples" / "synthetic_voices")
    frontend = Frontend(tiny_config(), device="cpu")
    got = eval_frontend_real.evaluate(samples, frontend)
    want = jeval.evaluate(samples)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("_mean") or k in ("separation_gap", "between_above_within_median"):
            assert abs(got[k] - v) <= COS_ATOL, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)
    one = tmp_path / "one" / "speaker_a"
    one.mkdir(parents=True)
    for p in (ROOT / "assets" / "samples" / "synthetic_voices" / "speaker_a").glob("*.wav"):
        (one / p.name).write_bytes(p.read_bytes())
    with pytest.raises(FileNotFoundError, match="need >=2 speakers"):
        eval_frontend_real.evaluate(str(tmp_path / "one"), frontend)
