"""The port's speech tokenizer and speaker encoder against the JAX package's,
f32, on the committed checkpoints and on a small seeded tree.

FSQ rounds tanh(z) * (L - 1) / 2 to the nearest integer, so an f32
difference near a half-integer would flip a token. Tokens must be exact, and
each check also holds the largest difference of the pre-rounding values
between the packages below the smallest distance of any of them to a
half-integer: the exact match is then structural, not luck of the seed.
Speaker embeddings within 1e-5 absolute (their values are ~0.06; the packages
differ by ~2e-7 here). The port's copies of the checkpoints and their
sidecars must be byte-equal to the JAX package's."""

import filecmp
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.frontend import speech_tokenizer as jst
from flowmirror_hydravox_tpu.train.checkpoint import load_params_npz as jax_load_npz
from flowmirror_hydravox_tpu.utils.audio import mel_spectrogram, whisper_log_mel
from flowmirror_hydravox_tpu_torch.frontend import frontend as torch_frontend
from flowmirror_hydravox_tpu_torch.frontend import speech_tokenizer as tst
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import n, t, to_numpy_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_CKPT = ROOT / "flowmirror_hydravox_tpu" / "frontend" / "assets" / "ckpt"
TORCH_CKPT = ROOT / "flowmirror_hydravox_tpu_torch" / "frontend" / "assets" / "ckpt"
EMB_ATOL = 1e-5


def voiced(sr: int, seconds: float, seed: int) -> np.ndarray:
    """A voiced harmonic signal with a wandering f0, an amplitude envelope and
    a little noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    f0 = 110 + 40 * rng.random() + 25 * np.sin(2 * np.pi * (0.3 + rng.random()) * tt)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (2 + 2 * rng.random()) * tt) ** 2
    x = sum(np.sin(k * phase + 6 * rng.random()) / k for k in range(1, 12)) * env
    x = 0.25 * x / np.abs(x).max() + 0.01 * rng.standard_normal(len(tt))
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["tokenizer.npz", "tokenizer.json", "speaker.npz",
                                  "speaker.json"])
def test_committed_checkpoints_are_copies(name):
    assert filecmp.cmp(JAX_CKPT / name, TORCH_CKPT / name, shallow=False)


def _trees(name, cfg, init):
    """(JAX tree, port tree) of the committed checkpoint `name`."""
    template = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))  # dtypes only
    jax_tree = jax_load_npz(str(JAX_CKPT / f"{name}.npz"), template)
    return jax_tree, from_numpy_tree(to_numpy_tree(jax_tree), "cpu")


@pytest.fixture(scope="module")
def committed():
    st_cfg = torch_frontend.load_extractor_cfg(str(TORCH_CKPT / "tokenizer.npz"), "tokenizer")
    spk_cfg = torch_frontend.load_extractor_cfg(str(TORCH_CKPT / "speaker.npz"), "speaker")
    jst_cfg = jst.SpeechTokenizerConfig(**vars(st_cfg))
    jspk_cfg = jst.SpeakerEncoderConfig(**vars(spk_cfg))
    return dict(tokenizer=(jst_cfg, st_cfg, *_trees("tokenizer", jst_cfg, jst.init_tokenizer_params)),
                speaker=(jspk_cfg, spk_cfg, *_trees("speaker", jspk_cfg, jst.init_speaker_params)))


def _seeded_tree(init, cfg, seed):
    """A numpy tree of the JAX init's structure: norm weights near 1, the
    rest N(0, 0.05); the FSQ projection N(0, 3), so that the codes spread
    over the lattice instead of sitting at its centre."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "ln" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        scale = 3.0 if "fsq_proj" in name else 0.05
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _small_trees():
    """A small seeded tokenizer (dim 64, 2 layers, 4 heads) and speaker
    encoder (dim 32, 3 layers)."""
    st_cfg = jst.SpeechTokenizerConfig(dim=64, num_layers=2, num_heads=4)
    spk_cfg = jst.SpeakerEncoderConfig(dim=32, num_layers=3)
    tok = _seeded_tree(jst.init_tokenizer_params, st_cfg, 7)
    spk = _seeded_tree(jst.init_speaker_params, spk_cfg, 8)
    return dict(
        tokenizer=(st_cfg, tst.SpeechTokenizerConfig(**vars(st_cfg)), tok,
                   from_numpy_tree(tok, "cpu")),
        speaker=(spk_cfg, tst.SpeakerEncoderConfig(**vars(spk_cfg)), spk,
                 from_numpy_tree(spk, "cpu")))


@pytest.fixture(scope="module")
def small():
    return _small_trees()


def _check_tokens(trees, wav16):
    jcfg, tcfg, jtree, ttree = trees["tokenizer"]
    mel = jax.jit(whisper_log_mel)(jnp.asarray(wav16))
    z_j = np.asarray(jax.jit(lambda p, m: jst.encode_fsq_values(p, jcfg, m))(jtree, mel))
    want = np.asarray(jst.fsq_encode(jnp.asarray(z_j), jcfg.fsq_levels))
    got = n(tst.tokenize_waveform(ttree, tcfg, t(wav16)))
    assert got.shape == want.shape == (wav16.shape[0], wav16.shape[1] // 640)
    np.testing.assert_array_equal(got, want)
    half = (np.asarray(jcfg.fsq_levels, np.float32) - 1) / 2
    v_j = np.tanh(z_j) * half
    v_t = n(tst.fsq_values(tst.encode_fsq_values(ttree, tcfg, t(np.asarray(mel))),
                           tcfg.fsq_levels))
    margin = np.abs(np.abs(v_j - np.floor(v_j)) - 0.5).min()
    assert np.abs(v_t - v_j).max() < margin, (np.abs(v_t - v_j).max(), margin)
    return got


def _check_embedding(trees, wav16):
    jcfg, tcfg, jtree, ttree = trees["speaker"]
    mel = np.asarray(jax.jit(lambda y: mel_spectrogram(y, 400, 80, 16000, 160, 400))(
        jnp.asarray(wav16)))
    want = np.asarray(jax.jit(lambda p, m: jst.speaker_embedding(p, jcfg, m))(jtree, mel))
    got = n(tst.speaker_embedding(ttree, tcfg, t(mel)))
    assert got.shape == want.shape == (wav16.shape[0], jcfg.embed_dim)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL, rtol=0)


@pytest.mark.parametrize("tree", ["committed", "small"])
def test_extractors_match_jax(tree, request):
    """Two prompts in one batch (3 s and a second seed), tokens and
    embeddings; on the committed checkpoints the tokens must not all be one
    code."""
    trees = request.getfixturevalue(tree)
    wav16 = np.stack([voiced(16000, 3.0, 0), voiced(16000, 3.0, 1)])
    tokens = _check_tokens(trees, wav16)
    assert len(np.unique(tokens)) > 5
    _check_embedding(trees, wav16)


def test_fsq_encode_matches_jax():
    z = (np.random.default_rng(3).standard_normal((4, 50, 8)) * 2).astype(np.float32)
    levels = (3, 5, 3, 4, 3, 3, 7, 3)
    want = np.asarray(jst.fsq_encode(jnp.asarray(z), levels))
    np.testing.assert_array_equal(n(tst.fsq_encode(t(z), levels)), want)
