"""The port's library API and its remaining serving routes (tiny config,
CPU):

- `HydraVox.inference_zero_shot` against the JAX `HydraVox` on the same
  tiny weights (the port loads them from `.npz` files through its
  `model_dir` rule; the JAX object is given the same trees), each with its
  package's frontend on the committed extractors and the same key: tokens
  exact through the engine, wav within WAV_LSB int16 steps; then the
  registry helpers and a stream of the same text;
- `HydraVox(spec_decode=True).inference_sft` against the JAX
  `HydraVox(spec_decode=True)` on the same trees and key: wav within
  WAV_LSB int16 steps (the tokens of a speculative decode differ from a
  blind multi-head one's on the same key);
- `quantize` takes the JAX modes (int8 serves: tests/test_torch_quant_serving.py),
  and an unknown one raises ValueError before any weights load;
- `GET /api/v1/devices`, `GET /api/v1/samples` and `POST
  /api/v1/samples/load`, a path outside the samples root giving 400."""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu import api as jax_api
from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.frontend.frontend import SpeakerInfo as JaxSpeakerInfo
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch.api import HydraVox
from flowmirror_hydravox_tpu_torch.params import flatten_params
from flowmirror_hydravox_tpu_torch.runtime.server import make_server
from flowmirror_hydravox_tpu_torch.utils.wavio import audio_to_base64
from tests.test_torch_frontend import _jax_frontend
from tests.test_torch_speech_tokenizer import voiced
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

WAV_LSB = 2 / 32767.0
MAX_TOKENS = 48
PROMPT = voiced(16000, 1.5, 30)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    for name, tree in zip(("llm", "flow", "hift"), seeded_tiny_trees()):
        np.savez(root / f"{name}.npz", **flatten_params(tree))
    return str(root)


@pytest.fixture(scope="module")
def hydravox(weights):
    return HydraVox(weights, tiny=True, max_tokens=MAX_TOKENS, dtype=torch.float32,
                    device="cpu")


def _jax_hydravox(port: HydraVox, spec_decode: bool = False):
    """The JAX HydraVox on the same trees, built without its random init."""
    hv = object.__new__(jax_api.HydraVox)
    hv.cfg = jax_tiny_config()
    hv.engine = JaxEngine(hv.cfg, *seeded_tiny_trees(), max_tokens=MAX_TOKENS,
                          spec_decode=spec_decode)
    hv.frontend = _jax_frontend(port.frontend)
    hv.sample_rate = hv.cfg.sample_rate
    hv._streamer = None
    return hv


def test_inference_zero_shot_matches_jax(hydravox, tmp_path):
    ref = _jax_hydravox(hydravox)
    args = ("A new line to speak.", "Hi there.", PROMPT, 16000)
    key = jax.random.PRNGKey(8)
    (want,) = ref.inference_zero_shot(*args, inference_head_num=2, rng=key)
    (got,) = hydravox.inference_zero_shot(*args, inference_head_num=2, noise=JaxReplayNoise(key))
    assert got["sample_rate"] == want["sample_rate"] == 24000
    assert got["tts_speech"].shape == want["tts_speech"].shape and len(got["tts_speech"]) > 0
    np.testing.assert_allclose(got["tts_speech"], want["tts_speech"], atol=WAV_LSB, rtol=0)

    assert hydravox.add_zero_shot_spk("Hi there.", PROMPT, 16000, "clone")
    assert hydravox.list_available_spks() == ["clone", "default"]
    (registered,) = hydravox.inference_zero_shot("A new line to speak.", "", None, 0,
                                                 zero_shot_spk_id="clone",
                                                 inference_head_num=2, noise=JaxReplayNoise(key))
    np.testing.assert_array_equal(registered["tts_speech"], got["tts_speech"])
    hydravox.save_spkinfo(str(tmp_path / "reg.npz"))
    assert sorted(np.load(tmp_path / "reg.npz").files)[0].startswith("clone::")
    chunks = [c["tts_speech"] for c in hydravox.inference_sft("Stream this line.", "clone",
                                                              stream=True)]
    assert chunks and all(np.isfinite(c).all() and len(c) > 0 for c in chunks)


@pytest.mark.parametrize("kwargs", [dict(quantize="int4")], ids=["quantize"])
def test_unported_options_raise(kwargs):
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        HydraVox(tiny=True, device="cpu", **kwargs)


def test_spec_decode_matches_jax(weights):
    port = HydraVox(weights, tiny=True, max_tokens=MAX_TOKENS, dtype=torch.float32,
                    device="cpu", spec_decode=True)
    ref = _jax_hydravox(port, spec_decode=True)
    # the zero embedding both HydraVox objects register when their registry is empty
    ref.frontend.add_speaker("default", JaxSpeakerInfo(embedding=np.zeros(192, np.float32)))
    assert port.engine.spec_decode and ref.engine.spec_decode
    key = jax.random.PRNGKey(4)
    (want,) = ref.inference_sft("Speak this line.", "default", inference_head_num=2, rng=key)
    (got,) = port.inference_sft("Speak this line.", "default", inference_head_num=2,
                                noise=JaxReplayNoise(key))
    assert got["tts_speech"].shape == want["tts_speech"].shape and len(got["tts_speech"]) > 0
    np.testing.assert_allclose(got["tts_speech"], want["tts_speech"], atol=WAV_LSB, rtol=0)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_devices_and_samples_routes(hydravox, tmp_path, monkeypatch):
    root = tmp_path / "samples"
    (root / "set" / "spk").mkdir(parents=True)
    wav_b64 = audio_to_base64(PROMPT, 16000)
    (root / "set" / "spk" / "a.wav").write_bytes(base64.b64decode(wav_b64))
    (root / "set" / "spk" / "a.txt").write_text("Hi there.\n")
    (root / "b.wav").write_bytes(base64.b64decode(wav_b64))
    (tmp_path / "outside.wav").write_bytes(b"RIFF")
    monkeypatch.setenv("TTS_SAMPLES_DIR", str(root))
    server = make_server("127.0.0.1", 0, hydravox.engine, hydravox.frontend)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api/v1"
    try:
        assert _call(url + "/devices") == (200, {
            "success": True, "message": "ok", "error": None,
            "data": {"platform": "cpu", "device_count": 1, "devices": ["cpu"],
                     "default_backend": "cpu"}})
        code, body = _call(url + "/samples")
        assert code == 200 and body["data"] == {"root": str(root), "samples": [
            {"name": "b", "path": "b.wav", "has_text": False},
            {"name": "set/spk/a", "path": "set/spk/a.wav", "has_text": True}]}
        assert _call(url + "/samples/load", {"path": "set/spk/a.wav"}) == (200, {
            "success": True, "message": "ok", "error": None,
            "data": {"audio_base64": wav_b64, "prompt_text": "Hi there."}})
        for path, error in (("../outside.wav", "path escapes the samples root"),
                            ("none.wav", "no such sample: none.wav")):
            assert _call(url + "/samples/load", {"path": path}) == (400, {
                "success": False, "message": "bad sample path", "data": None, "error": error})
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
