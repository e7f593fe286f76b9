"""The port's preprocessing models (preprocess/vad_model.py, asr_model.py),
their tools (tools/eval_vad.py, eval_asr.py) and the synthetic-speech copy
(train/synth_speech.py) against the JAX package's on the CPU.

- The shipped VAD and ASR checkpoints are byte-identical copies, and the
  numpy synthesis gives JAX's arrays for a few seeds.
- VAD probabilities at f32 on a clean and a noisy clip (and a 24 kHz one,
  resampled by both) within 1e-5 absolute, the same segments from
  `detect_speech`; `auto` falls back to the energy VAD only when no weights
  exist.
- ASR logits at f32 on a two-row batch with per-row lengths within 2e-3
  absolute (logits up to ~20: the log-mel, three attention blocks and the
  head accumulate f32 rounding differently), the paddings equal; NativeASR's
  text equal on 3 held-out clips; the checkpoint format read by both.
- eval_vad's F1 table and eval_asr's TERs equal JAX's on the same clips.

One JAX NativeVAD and one NativeASR serve the file; every clip is 4 s, so
each JAX program compiles once."""

import os

import jax
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.preprocess import asr_model as jax_asr
from flowmirror_hydravox_tpu.preprocess import vad as jax_vad
from flowmirror_hydravox_tpu.preprocess import vad_model as jax_vad_model
from flowmirror_hydravox_tpu.tools import eval_asr as jax_eval_asr
from flowmirror_hydravox_tpu.tools import eval_vad as jax_eval_vad
from flowmirror_hydravox_tpu.train import synth_speech as jax_synth
from flowmirror_hydravox_tpu_torch.preprocess import asr_model, vad, vad_model
from flowmirror_hydravox_tpu_torch.tools import eval_asr, eval_vad
from flowmirror_hydravox_tpu_torch.train import synth_speech
from flowmirror_hydravox_tpu_torch.utils.wavio import encode_wav
from tests.torch_port_util import n, t

VAD_ATOL = 1e-5
LOGIT_ATOL = 2e-3
SECONDS = 4.0


@pytest.fixture(scope="module")
def jax_vad_native():
    return jax_vad_model.NativeVAD()


@pytest.fixture(scope="module")
def jax_asr_native():
    return jax_asr.NativeASR()


def _heldout(c):
    """Held-out clip c of eval_asr / test_asr (speaker 300 + c, utterance
    10000 + c)."""
    return synth_speech.synth_utterance_with_segments(300 + c, 10_000 + c, SECONDS, seed=1)


def test_assets_and_synthesis_match_jax():
    for name in ("vad.npz", "asr.npz"):
        jax_copy, port_copy = (os.path.join(os.path.dirname(m.__file__), "assets", name)
                               for m in (jax_vad_model, vad_model))
        with open(jax_copy, "rb") as a, open(port_copy, "rb") as b:
            assert a.read() == b.read(), name
    for spk, utt, sec, seed in ((3, 0, 2.0, 0), (300, 10_000, 1.5, 1), (77, 5_000_001, 1.0, 3)):
        for fn in ("synth_utterance_with_mask", "synth_utterance_with_segments"):
            got = getattr(synth_speech, fn)(spk, utt, sec, seed)
            want = getattr(jax_synth, fn)(spk, utt, sec, seed)
            np.testing.assert_array_equal(got[0], want[0])
            assert (np.array_equal(got[1], want[1]) if fn.endswith("mask")
                    else got[1] == want[1])
    for kind in ("white", "pink", "hum", "babble"):
        np.testing.assert_array_equal(
            synth_speech.synth_noise(kind, 4000, np.random.default_rng(5)),
            jax_synth.synth_noise(kind, 4000, np.random.default_rng(5)))


def test_vad_probs_and_segments_match_jax(jax_vad_native):
    port = vad_model.NativeVAD(device="cpu")
    wav, mask = synth_speech.synth_utterance_with_mask(301, 10_001, SECONDS, seed=3)
    noise = synth_speech.synth_noise("hum", len(wav), np.random.default_rng(0))
    noisy = wav + noise * np.sqrt(np.mean(wav ** 2) / np.mean(noise ** 2)) * 10 ** (-5 / 20)
    x24 = np.interp(np.arange(int(SECONDS * 24000)) * (16000 / 24000), np.arange(len(wav)),
                    wav).astype(np.float32)
    cfg = vad.VADConfig(min_gap_s=0.12, min_dur_s=0.1)
    for clip, sr in ((wav, 16000), (noisy.astype(np.float32), 16000), (x24, 24000)):
        got, want = port(clip, sr), np.asarray(jax_vad_native(clip, sr))
        assert got.shape == want.shape == (int(SECONDS * 100),)
        np.testing.assert_allclose(got, want, rtol=0, atol=VAD_ATOL)
        assert vad.detect_speech(clip, sr, cfg, port) == jax_vad.detect_speech(
            clip, sr, jax_vad.VADConfig(min_gap_s=0.12, min_dur_s=0.1), jax_vad_native)
    # the numpy energy detector, as copied
    assert vad.detect_speech(noisy, 16000) == jax_vad.detect_speech(noisy, 16000)


def test_vad_falls_back_only_without_weights(tmp_path, monkeypatch):
    assert vad_model.maybe_native_vad(str(tmp_path / "none.npz"), device="cpu") is None
    assert isinstance(vad_model.maybe_native_vad(device="cpu"), vad_model.NativeVAD)
    if not torch.cuda.is_available():  # a device fault raises, never the energy VAD
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            vad_model.maybe_native_vad(device="cuda")
    src, sr = tmp_path / "in", 16000
    src.mkdir()
    tone = (0.3 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32)
    (src / "x.wav").write_bytes(encode_wav(np.concatenate([tone, np.zeros(sr, np.float32),
                                                           tone]), sr))
    monkeypatch.setenv("HYDRAVOX_VAD_NPZ", str(tmp_path / "none.npz"))
    monkeypatch.setattr(vad_model, "_ASSET", str(tmp_path / "none.npz"))
    with pytest.raises(SystemExit, match="no trained VAD weights"):
        vad.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "o"),
                  "--model", "native", "--device", "cpu"])
    vad.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "auto"),
              "--model", "auto", "--min_dur", "0.3"])  # no weights: energy, no device
    assert len(list((tmp_path / "auto").rglob("*.wav"))) >= 2


def test_asr_logits_match_jax(jax_asr_native):
    port = asr_model.NativeASR(device="cpu")
    assert port.cfg == asr_model.ASRModelConfig(**vars(jax_asr_native.cfg))
    assert port.vocab == jax_asr_native.vocab
    wav = np.stack([_heldout(1)[0], _heldout(2)[0]])
    wav[1, 50_000:] = 0.0
    lens = np.array([wav.shape[1], 50_000], np.int32)
    want, want_pad = jax.jit(jax_asr.logits, static_argnums=1)(  # one compile, not one per op
        jax_asr_native.params, jax_asr_native.cfg, wav, lens)
    got, got_pad = asr_model.logits(port.params, port.cfg, t(wav), t(lens))
    np.testing.assert_array_equal(n(got_pad), np.asarray(want_pad))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_native_asr_text_and_checkpoint_match_jax(jax_asr_native, tmp_path):
    port = asr_model.NativeASR(device="cpu")
    for c in range(3):
        wav, segs = _heldout(c)
        text = port(wav, 16000)
        assert text == jax_asr_native(wav, 16000), c
        assert asr_model.token_error_rate(segs, list(text)) == jax_asr.token_error_rate(
            segs, list(text))
    ids = np.random.default_rng(0).integers(0, 4, 40)
    assert asr_model.greedy_decode(ids, 33) == jax_asr.greedy_decode(ids, 33)
    path = str(tmp_path / "asr.npz")
    asr_model.save_ckpt(path, port.params, port.cfg, port.vocab)
    params, cfg, vocab = jax_asr.load_ckpt(path)  # the JAX reader, on the port's file
    assert (cfg, vocab) == (jax_asr_native.cfg, jax_asr_native.vocab)
    back, cfg2, vocab2 = asr_model.load_ckpt(path)
    assert (cfg2, vocab2) == (port.cfg, port.vocab)
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(np.asarray(params["layers"][i]["conv_dw"]),
                                      n(port.params["layers"][i]["conv_dw"]))
        assert torch.equal(back["layers"][i]["wq"], port.params["layers"][i]["wq"])
    with pytest.raises(ValueError, match="vocab_size"):
        asr_model.save_ckpt(path, port.params, port.cfg, port.vocab[:-1])


def test_eval_tools_match_jax(jax_vad_native, jax_asr_native, monkeypatch):
    # the JAX tools build their own models: hand them the file's compiled ones
    monkeypatch.setattr(jax_vad_model, "maybe_native_vad", lambda: jax_vad_native)
    monkeypatch.setattr(jax_asr, "NativeASR", lambda ckpt=None: jax_asr_native)
    want = jax_eval_vad.evaluate(n_clips=1, snr_db=5.0, seconds=SECONDS)
    got = eval_vad.evaluate(n_clips=1, snr_db=5.0, seconds=SECONDS, device="cpu")
    assert got.keys() == want.keys()
    for cond in want:
        assert got[cond].keys() == want[cond].keys() == {"energy", "native"}
        for det in want[cond]:
            np.testing.assert_allclose(got[cond][det], want[cond][det], rtol=0, atol=1e-9)
    assert eval_asr.evaluate(n_clips=2, device="cpu") == jax_eval_asr.evaluate(n_clips=2)
