"""Port HiFT vocoder against the JAX package (tiny config, f32), with the JAX
NSF-source noise fed into the port; CausalHiFT (`inference_causal`) with
JAX's two fixed noise buffers fed in, `finalize` on and off, on the random
tree (F0 under the voiced threshold: the source is its noise) and on a
voiced copy (the sine half in the waveform), its source alone, and its
growing-prefix property on the port's own buffers, on both trees.

Tolerances: STFT pair atol 1e-5; the waveform atol 1e-4 (the phase cumsum
and five conv stages accumulate f32 summation-order differences), the
causal one too; a grown prefix within 5e-2 of the whole (JAX's bar,
tests/test_hift.py: the ISTFT's edge frames)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import hift as jh
from flowmirror_hydravox_tpu_torch.models import hift as th
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import JaxReplayNoise, jit_o0, n, seeded_tiny_trees, t

CFG = tiny_config().hift
VOICED_HZ = 150.0  # the F0 of the voiced causal cases


@pytest.fixture(scope="module")
def params():
    jp = seeded_tiny_trees()[2]  # the JAX init of HiFT takes tens of seconds
    return jp, from_numpy_tree(jp, "cpu")


def test_stft_istft_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 480)).astype(np.float32)
    jr, ji = jit_o0(lambda x: jh._stft_16(x, 16, 4))(jnp.asarray(x))
    tr, ti = th._stft_16(t(x), 16, 4)
    np.testing.assert_allclose(n(tr), n(jr), atol=1e-5)
    np.testing.assert_allclose(n(ti), n(ji), atol=1e-5)
    np.testing.assert_allclose(n(th._istft_16(tr, ti, 16, 4)),
                               n(jit_o0(lambda r, i: jh._istft_16(r, i, 16, 4))(jr, ji)),
                               atol=1e-5)


def test_interp_and_conv_transpose_match_jax(params):
    jp, tp = params
    x = np.random.default_rng(1).standard_normal((2, 9, 37)).astype(np.float32)
    for out_len in (12, 111):
        np.testing.assert_allclose(
            n(th._interp_linear(t(x), out_len)),
            n(jit_o0(lambda x, o=out_len: jh._interp_linear(x, o))(jnp.asarray(x))), atol=1e-6)
    u, k = CFG.upsample_rates[0], CFG.upsample_kernel_sizes[0]
    xin = np.random.default_rng(2).standard_normal((1, CFG.base_channels, 20)).astype(np.float32)
    np.testing.assert_allclose(
        n(th.conv_transpose1d(tp["ups"][0], t(xin), u, (k - u) // 2)),
        n(jit_o0(lambda p, x: jh.conv_transpose1d(p, x, u, (k - u) // 2))(
            jp["ups"][0], jnp.asarray(xin))), atol=1e-5)


def test_sine_source_matches_jax_with_fed_noise():
    rng = np.random.default_rng(4)
    t_frames = 6
    f0 = np.abs(rng.standard_normal((1, t_frames)) * 120.0 + 150.0).astype(np.float32)
    f0[0, 2] = 0.0  # one unvoiced frame
    f0_up = np.repeat(f0, CFG.upsample_scale, axis=-1)[..., None]
    key = jax.random.PRNGKey(9)
    want, wuv = jax.jit(lambda k, f0: jh.sine_source(k, CFG, f0))(key, jnp.asarray(f0_up))
    rand_ini, noise = JaxReplayNoise(key).vocoder(1, f0_up.shape[1], CFG.nb_harmonics + 1)
    got, guv = th.sine_source(CFG, t(f0_up), rand_ini, noise)
    np.testing.assert_array_equal(n(guv), n(wuv))
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


_JAX_INFERENCE = jit_o0(lambda p, mel, key: jh.inference(p, CFG, mel, key))
_JAX_F0 = jit_o0(lambda p, mel: jh.predict_f0(p, mel))


@pytest.mark.parametrize("t_mel", [16, 40])
def test_inference_matches_jax(params, t_mel):
    jp, tp = params
    mel = np.random.default_rng(5).standard_normal((1, 80, t_mel)).astype(np.float32)
    key = jax.random.PRNGKey(t_mel)
    want = _JAX_INFERENCE(jp, jnp.asarray(mel), key)
    got = th.inference(tp, CFG, t(mel), JaxReplayNoise(key))
    assert got.shape == (1, t_mel * CFG.upsample_scale)
    np.testing.assert_allclose(n(th.predict_f0(tp, t(mel))), n(_JAX_F0(jp, jnp.asarray(mel))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)



_JAX_CAUSAL = {fin: jit_o0(lambda p, mel, fin=fin: jh.inference_causal(p, CFG, mel, fin))
               for fin in (True, False)}


@functools.lru_cache(maxsize=1)
def _jax_fixed_noise():
    """JAX's two fixed CausalHiFT buffers (hift.py:422-424, :441, :452)."""
    nh = CFG.nb_harmonics + 1
    return (np.asarray(jh._fixed_noise((1, nh), 101)),
            np.asarray(jh._fixed_noise((1, 300 * 24000 // nh, nh), 102)))


def _voiced(tree, hz: float = VOICED_HZ):
    """A HiFT tree (numpy or torch leaves) whose F0 predictor sits near `hz`:
    the classifier's bias moved up by `hz`, so that every frame is voiced.
    The random trees' F0 lies below the 10 Hz threshold, where the causal
    source is its noise alone and its sine half is multiplied by zero."""
    f0p = tree["f0_predictor"]
    cls = {**f0p["classifier"], "b": f0p["classifier"]["b"] + hz}
    return {**tree, "f0_predictor": {**f0p, "classifier": cls}}


def _causal_against_jax(jp, tp, finalize):
    """inference_causal of the port and of JAX on one mel and JAX's buffers;
    returns the port's F0 of that mel."""
    rand_ini, noise = _jax_fixed_noise()
    t_mel = 40
    mel = np.random.default_rng(6).standard_normal((1, 80, t_mel)).astype(np.float32) * 0.5
    want = _JAX_CAUSAL[finalize](jp, jnp.asarray(mel))
    got = th.inference_causal(tp, CFG, t(mel), t(rand_ini), t(noise), finalize=finalize)
    lookahead = 0 if finalize else 2 + 6
    trim = 0 if finalize else math.prod(CFG.upsample_rates) * CFG.istft_hop_len
    assert got.shape == want.shape == (1, (t_mel - lookahead) * CFG.upsample_scale - trim)
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    return n(th.predict_f0_causal(tp, CFG, t(mel), finalize))


@pytest.mark.parametrize("finalize", [True, False])
def test_inference_causal_matches_jax(params, finalize):
    jp, tp = params
    assert (th.f0_look_right(tp), th.conv_pre_look_right(tp)) == \
        (jh.f0_look_right(jp), jh.conv_pre_look_right(jp)) == (2, 6)
    rand_ini, noise = _jax_fixed_noise()
    assert tuple(x.shape for x in th.causal_noise(CFG, "cpu")) == (rand_ini.shape, noise.shape)
    _causal_against_jax(jp, tp, finalize)


@pytest.mark.parametrize("finalize", [True, False])
def test_inference_causal_voiced_matches_jax(params, finalize):
    """The same with every frame voiced: the sine half of the source (its
    phase offset, remainder, frame cumsum and nearest phase upsample) in
    the waveform."""
    jp, tp = params
    f0 = _causal_against_jax(_voiced(jp), _voiced(tp), finalize)
    assert (f0 > CFG.nsf_voiced_threshold).all() and f0.std() > 0.01, f0


def test_sine_source_causal_matches_jax():
    """The causal source alone against JAX's on JAX's buffers: two rows of
    F0 around 150 Hz, each with one unvoiced frame."""
    rng = np.random.default_rng(8)
    f0 = np.abs(rng.standard_normal((2, 12)) * 120.0 + 150.0).astype(np.float32)
    f0[0, 2] = f0[1, 7] = 0.0
    f0_up = np.repeat(f0, CFG.upsample_scale, axis=-1)[..., None]
    want, wuv = jit_o0(lambda f: jh.sine_source_causal(CFG, f))(jnp.asarray(f0_up))
    rand_ini, noise = _jax_fixed_noise()
    got, guv = th.sine_source_causal(CFG, t(f0_up), t(rand_ini), t(noise))
    np.testing.assert_array_equal(n(guv), n(wuv))
    assert 0.8 < n(guv).mean() < 1.0
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


def _growing_prefix(tp):
    """Calls on a growing prefix (10-frame chunks, finalized once the end
    is in) against the whole call: the largest difference."""
    rand_ini, noise = th.causal_noise(CFG, "cpu", seed=3)
    t_mel, chunk, up = 40, 10, CFG.upsample_scale
    mel = t(np.random.default_rng(7).standard_normal((1, 80, t_mel)).astype(np.float32) * 0.5)
    full = n(th.inference_causal(tp, CFG, mel, rand_ini, noise))
    ctx = th.f0_look_right(tp) + th.conv_pre_look_right(tp)
    max_err, covered = 0.0, 0
    for i in range(0, t_mel, chunk):
        end = i + chunk + ctx
        part = n(th.inference_causal(tp, CFG, mel[:, :, : min(end, t_mel)], rand_ini, noise,
                                     finalize=end >= t_mel))
        seg = part[:, i * up:]
        max_err = max(max_err, float(np.abs(seg - full[:, i * up: i * up + seg.shape[1]]).max()))
        covered = i * up + seg.shape[1]
    assert covered == full.shape[1]
    return max_err


def test_inference_causal_growing_prefix(params):
    """A grown prefix reproduces the whole call's samples
    (tests/test_hift.py)."""
    max_err = _growing_prefix(params[1])
    assert max_err < 5e-2, max_err


def test_inference_causal_growing_prefix_voiced(params):
    """The same with every frame voiced."""
    max_err = _growing_prefix(_voiced(params[1]))
    assert max_err < 5e-2, max_err
