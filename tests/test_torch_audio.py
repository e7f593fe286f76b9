"""The port's utils/audio.py against the JAX package's on seeded numpy
signals, f32.

Tolerances: the filterbank and the Hann window are the same numpy code, so
equal; the log-mels (natural log, and whisper's log10 scaled by 1/4) within
1e-5 absolute (rfft in jnp and torch agrees to ~1e-6 relative); the resampler
within 1e-6 (its source positions are the same f32 products, so the
interpolation weights agree to the bit and only the blend may round
otherwise). Reflect padding is numpy's, also past the signal's length, which
`torch.nn.functional.pad` refuses: a 180-sample 16 kHz input to whisper's
200-sample pad and a 600-sample 24 kHz input to the mel's 720-sample pad."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.utils import audio as jax_audio
from flowmirror_hydravox_tpu_torch.utils import audio as torch_audio
from tests.torch_port_util import n, t

LOG_MEL_ATOL = 1e-5
RESAMPLE_ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jit(name, **static):
    """A jitted JAX reference: one compile per shape instead of one per op."""
    return jax.jit(functools.partial(getattr(jax_audio, name), **static))


def _signal(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("args", [(24000, 1920, 80), (16000, 400, 80), (16000, 400, 128)],
                         ids=["flow", "speaker", "whisper"])
def test_mel_filterbank_and_window(args):
    np.testing.assert_array_equal(torch_audio.mel_filterbank(*args),
                                  jax_audio.mel_filterbank(*args))
    np.testing.assert_array_equal(torch_audio.hann_window(args[1]),
                                  jax_audio.hann_window(args[1]))


@pytest.mark.parametrize("length,pad", [(1, 3), (2, 5), (5, 7), (100, 3), (180, 200),
                                        (600, 720), (700, 720)])
def test_reflect_pad_matches_numpy(length, pad):
    x = _signal((2, length), length)
    want = np.asarray(jnp.pad(jnp.asarray(x), [(0, 0), (pad, pad)], mode="reflect"))
    np.testing.assert_array_equal(n(torch_audio.reflect_pad(t(x), pad)), want)


@pytest.mark.parametrize("shape,kwargs", [
    ((2, 24000), {}),  # the flow's 24 kHz mel, a batch of 2
    ((1, 600), {}),  # shorter than its 720-sample reflect pad
    ((1, 16000), dict(n_fft=400, num_mels=80, sampling_rate=16000, hop_size=160,
                      win_size=400)),  # the speaker encoder's features
    ((1, 8000), dict(n_fft=512, num_mels=40, sampling_rate=16000, hop_size=128,
                     win_size=300)),  # a window shorter than n_fft
], ids=["24k", "24k_short", "16k_speaker", "short_window"])
def test_mel_spectrogram(shape, kwargs):
    x = _signal(shape, sum(shape))
    want = np.asarray(_jit("mel_spectrogram", **kwargs)(jnp.asarray(x)))
    got = n(torch_audio.mel_spectrogram(t(x), **kwargs))
    assert got.shape == want.shape and got.shape[-1] > 0
    np.testing.assert_allclose(got, want, atol=LOG_MEL_ATOL, rtol=0)
    hop, win = kwargs.get("hop_size", 480), kwargs.get("win_size", 1920)
    frames = np.asarray(jax_audio.frame_signal(jnp.asarray(x), win, hop))
    np.testing.assert_array_equal(n(torch_audio.frame_signal(t(x), win, hop)), frames)


@pytest.mark.parametrize("shape", [(1, 48000), (2, 16000), (1, 180)],
                         ids=["3s", "batch2", "shorter_than_pad"])
def test_whisper_log_mel(shape):
    x = _signal(shape, shape[1])
    want = np.asarray(_jit("whisper_log_mel")(jnp.asarray(x)))
    got = n(torch_audio.whisper_log_mel(t(x)))
    assert got.shape == want.shape == (shape[0], 128, shape[1] // 160)
    np.testing.assert_allclose(got, want, atol=LOG_MEL_ATOL, rtol=0)


@pytest.mark.parametrize("orig,target,seconds", [(16000, 24000, 3.0), (24000, 16000, 30.0),
                                                 (22050, 16000, 2.0), (24000, 24000, 0.5)])
def test_resample_linear(orig, target, seconds):
    """30 s at 24 kHz: the source positions keep few fraction bits in f32, so
    they must be built as the JAX function builds them."""
    x = _signal((1, int(orig * seconds)), orig)
    want = np.asarray(_jit("resample_linear", orig_sr=orig, target_sr=target)(jnp.asarray(x)))
    got = n(torch_audio.resample_linear(t(x), orig, target))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL, rtol=0)


def test_stft_magnitude():
    x = _signal((2, 4000), 7)
    win = jax_audio.hann_window(300)
    want = np.asarray(jax.jit(lambda y: jax_audio.stft_magnitude(y, 512, 100, 300, win))(
        jnp.asarray(x)))
    got = n(torch_audio.stft_magnitude(t(x), 512, 100, 300, torch.from_numpy(win)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
