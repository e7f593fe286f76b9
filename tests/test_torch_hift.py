"""Port HiFT vocoder against the JAX package (tiny config, f32), with the JAX
NSF-source noise fed into the port.

Tolerances: STFT pair atol 1e-5; the waveform atol 1e-4 (the phase cumsum
and five conv stages accumulate f32 summation-order differences)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import hift as jh
from flowmirror_hydravox_tpu_torch.models import hift as th
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from tests.torch_port_util import JaxReplayNoise, n, seeded_tiny_trees, t

CFG = tiny_config().hift


@pytest.fixture(scope="module")
def params():
    jp = seeded_tiny_trees()[2]  # the JAX init of HiFT takes tens of seconds
    return jp, from_numpy_tree(jp, "cpu")


def test_stft_istft_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 480)).astype(np.float32)
    jr, ji = jh._stft_16(jnp.asarray(x), 16, 4)
    tr, ti = th._stft_16(t(x), 16, 4)
    np.testing.assert_allclose(n(tr), n(jr), atol=1e-5)
    np.testing.assert_allclose(n(ti), n(ji), atol=1e-5)
    np.testing.assert_allclose(n(th._istft_16(tr, ti, 16, 4)),
                               n(jh._istft_16(jr, ji, 16, 4)), atol=1e-5)


def test_interp_and_conv_transpose_match_jax(params):
    jp, tp = params
    x = np.random.default_rng(1).standard_normal((2, 9, 37)).astype(np.float32)
    for out_len in (12, 111):
        np.testing.assert_allclose(n(th._interp_linear(t(x), out_len)),
                                   n(jh._interp_linear(jnp.asarray(x), out_len)), atol=1e-6)
    u, k = CFG.upsample_rates[0], CFG.upsample_kernel_sizes[0]
    xin = np.random.default_rng(2).standard_normal((1, CFG.base_channels, 20)).astype(np.float32)
    np.testing.assert_allclose(
        n(th.conv_transpose1d(tp["ups"][0], t(xin), u, (k - u) // 2)),
        n(jh.conv_transpose1d(jp["ups"][0], jnp.asarray(xin), u, (k - u) // 2)), atol=1e-5)


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


# the JAX references jitted, as the JAX engine runs them: one compile per
# shape where the eager calls compiled each op (~13 s a case on one core)
_JAX_INFERENCE = jax.jit(lambda p, mel, key: jh.inference(p, CFG, mel, key))
_JAX_F0 = jax.jit(lambda p, mel: jh.predict_f0(p, mel))


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
