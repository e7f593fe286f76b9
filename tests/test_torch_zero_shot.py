"""Zero-shot, cross-lingual and voice conversion through the port's Engine
against the JAX two-stage engine (`Engine(fused=False)`), and the server's
zero-shot, voice-conversion and speaker-registry routes, `last_prompt` and
the launcher's `--spk2info`, on the CPU (tiny config, f32).

The prompt features come from the port's frontend on the committed
extractors (tests/test_torch_frontend.py holds them to the JAX frontend);
both engines get the same arrays and the port replays the JAX key chain.
Tokens and step counts must be exact; wavs within WAV_LSB int16 steps."""

import base64
import contextlib
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend, SpeakerInfo
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from flowmirror_hydravox_tpu_torch.runtime.server import make_server
from flowmirror_hydravox_tpu_torch.utils.wavio import audio_to_base64
from tests.test_torch_speech_tokenizer import voiced
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

WAV_LSB = 2 / 32767.0
MAX_TOKENS = 48
PROMPT = voiced(16000, 1.5, 30)
SOURCE = voiced(24000, 1.0, 31)


@pytest.fixture(scope="module")
def engines():
    trees = seeded_tiny_trees()
    jax_engine = JaxEngine(tiny_config(), *trees, max_tokens=MAX_TOKENS, fused=False)
    torch_engine = TorchEngine(jax_engine.cfg, *(from_numpy_tree(tr, "cpu") for tr in trees),
                               max_tokens=MAX_TOKENS, device="cpu", fused=False)
    return jax_engine, torch_engine


@pytest.fixture(scope="module")
def frontend():
    return Frontend(tiny_config(), device="cpu")


def _features(frontend, mode):
    if mode == "cross_lingual":
        return frontend.frontend_cross_lingual("Say it in another tongue.", PROMPT, 16000)
    return frontend.frontend_zero_shot("A new line to speak.", "Hi there.", PROMPT, 16000)


@pytest.mark.parametrize("mode", ["zero_shot", "cross_lingual"])
def test_zero_shot_synthesize_matches_jax(engines, frontend, mode):
    jax_engine, torch_engine = engines
    feats = _features(frontend, mode)
    assert len(feats["prompt_speech_tokens"]) > 20
    kwargs = dict(text_tokens=feats["text_tokens"], tts_text_len=feats["tts_text_len"],
                  inference_head_num=2, prompt_speech_tokens=feats["prompt_speech_tokens"],
                  prompt_mel=feats["prompt_mel"], spk_embedding=feats["spk_embedding"],
                  llm_prompt_speech_tokens=feats.get("llm_prompt_speech_tokens"))
    key = jax.random.PRNGKey(40 + len(mode))
    want = jax_engine.synthesize(rng=key, **kwargs)
    got = torch_engine.synthesize(noise=JaxReplayNoise(key), **kwargs)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.steps == want.steps and len(got.speech_tokens) > 0
    assert got.audio.shape == want.audio.shape
    np.testing.assert_allclose(got.audio, want.audio, atol=WAV_LSB, rtol=0)


def test_voice_convert_matches_jax(engines, frontend):
    jax_engine, torch_engine = engines
    feats = frontend.frontend_vc(SOURCE, 24000, PROMPT, 16000)
    args = (feats["source_speech_tokens"], feats["prompt_speech_tokens"], feats["prompt_mel"],
            feats["spk_embedding"])
    key = jax.random.PRNGKey(50)
    want = jax_engine.voice_convert(*args, rng=key)
    got = torch_engine.voice_convert(*args, noise=JaxReplayNoise(key))
    assert got.shape == want.shape == (len(args[0]) * 2 * 480,)
    np.testing.assert_allclose(got, want, atol=WAV_LSB, rtol=0)


# -- the server ---------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """A tiny random-weight server: (url, engine, frontend)."""
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", "32"]))
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=300.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", engine, frontend
    server.shutdown()
    server.RequestHandlerClass.service.shutdown()
    server.server_close()


def _post(url, path, body):
    req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _wav(body) -> np.ndarray:
    """The response's WAV: 24 kHz, non-empty, finite, its duration field right."""
    assert body["success"] and body["error"] is None and body["data"]["sample_rate"] == 24000
    with wave.open(io.BytesIO(base64.b64decode(body["data"]["audio_base64"]))) as w:
        assert w.getframerate() == 24000
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert pcm.size > 0 and body["data"]["duration"] == pytest.approx(pcm.size / 24000)
    return pcm


@contextlib.contextmanager
def _engine_calls(engine):
    """Record each Engine.synthesize call's kwargs and result."""
    calls, inner = [], engine.synthesize

    def record(**kwargs):
        res = inner(**kwargs)
        calls.append((kwargs, res))
        return res

    engine.synthesize = record
    try:
        yield calls
    finally:
        engine.synthesize = inner


B64_PROMPT = audio_to_base64(PROMPT, 16000)


@pytest.mark.parametrize("mode", ["zero_shot", "cross_lingual", "instruct2"])
def test_zero_shot_route(served, mode):
    """Each mode through the worker, one Engine.synthesize per segment, with
    the mode's LM prefix; a seed repeats the audio bit for bit."""
    url, engine, _ = served
    body = {"tts_text": "One sentence here! And a second one.", "prompt_text": "Hi there.",
            "prompt_audio_base64": B64_PROMPT, "mode": mode, "extra_params": {"seed": 3}}
    with _engine_calls(engine) as calls:
        code, first = _post(url, "/api/v1/zero-shot", body)
        assert code == 200, first
        pcm = _wav(first)
    assert len(calls) == 2
    for kwargs, _ in calls:
        assert len(kwargs["prompt_speech_tokens"]) > 20 and kwargs["inference_head_num"] == 2
        lm_prefix = kwargs["llm_prompt_speech_tokens"]
        assert (lm_prefix is None) == (mode == "zero_shot")
        if lm_prefix is not None:
            assert len(lm_prefix) == 0
    assert sum(len(r.audio) for _, r in calls) == pcm.size  # joined with no pause
    code, again = _post(url, "/api/v1/zero-shot", body)
    assert code == 200 and again["data"]["audio_base64"] == first["data"]["audio_base64"]


def test_vc_route(served):
    url, engine, _ = served
    code, body = _post(url, "/api/v1/vc", {"source_audio_base64": audio_to_base64(SOURCE, 24000),
                                           "prompt_audio_base64": B64_PROMPT})
    assert code == 200, body
    assert _wav(body).size == 25 * 2 * 480  # 1 s of source speech at 25 tokens/s


@pytest.mark.parametrize("path,body,message,error", [
    ("/api/v1/zero-shot", {"tts_text": "x"}, "missing prompt audio",
     "prompt_audio_base64 required"),
    ("/api/v1/vc", {"prompt_audio_base64": B64_PROMPT}, "missing audio",
     "source_audio_base64 + prompt_audio_base64 required"),
    ("/api/v1/speakers/add", {"speaker_id": "x"}, "missing fields",
     "speaker_id + (audio_base64 or dataset_dir) required"),
], ids=["zero_shot", "vc", "speakers_add"])
def test_missing_fields_give_400(served, path, body, message, error):
    """The JAX server's codes and fields (server.py:1172-1199, :1349-1379)."""
    assert _post(served[0], path, body) == (400, {"success": False, "message": message,
                                                  "data": None, "error": error})


def test_speaker_registry_routes(served, tmp_path):
    url, _, frontend = served
    code, body = _post(url, "/api/v1/speakers/add", {
        "speaker_id": "clone", "audio_base64": B64_PROMPT, "prompt_text": "Hi there."})
    assert (code, body["data"]) == (200, {"speaker_id": "clone"})
    info = frontend.spk2info["clone"]
    assert len(info.prompt_mel) == 2 * len(info.prompt_speech_tokens) > 0
    assert list(info.prompt_text) == list(frontend.extract_text_tokens("Hi there."))
    with urllib.request.urlopen(url + "/api/v1/speakers", timeout=60) as r:
        assert json.load(r)["data"]["speakers"] == ["clone", "default"]
    code, body = _post(url, "/api/v1/tts", {"text": "Speak as the clone.", "speaker_id": "clone"})
    assert code == 200 and _wav(body).size > 0

    code, body = _post(url, "/api/v1/speakers/add", {"speaker_id": "d",
                                                     "dataset_dir": str(tmp_path / "none")})
    assert code == 400 and body["message"] == "bad dataset"

    assert _post(url, "/api/v1/speakers/remove/clone", {}) == (
        200, {"success": True, "message": "removed", "data": None, "error": None})
    assert _post(url, "/api/v1/speakers/remove/clone", {}) == (
        404, {"success": False, "message": "unknown speaker", "data": None,
              "error": "unknown speaker clone"})
    code, body = _post(url, "/api/v1/tts", {"text": "Gone.", "speaker_id": "clone"})
    assert code == 500 and "default" in body["error"] and "clone" in body["error"]


def test_last_prompt_rolls_each_segment_into_the_next(served):
    """`last_prompt`: every segment on its own through Engine.synthesize, and
    each segment's tokens and mel (extracted from its wav) are the next one's
    zero-shot prompt (server.py:721-741)."""
    url, engine, frontend = served
    text = "The first part is here! Is this the second part? And the third closes."
    with _engine_calls(engine) as calls:
        code, body = _post(url, "/api/v1/tts", {"text": text, "speaker_id": "default",
                                                "last_prompt": True,
                                                "extra_params": {"seed": 5}})
        assert code == 200, body
        _wav(body)
    assert len(calls) == 3
    assert calls[0][0]["prompt_speech_tokens"] is None
    for (kwargs, _), (_, prev) in zip(calls[1:], calls[:-1]):
        mel = frontend.extract_mel(prev.audio, 24000)
        n_prompt = min(len(prev.speech_tokens), len(mel) // 2)
        np.testing.assert_array_equal(kwargs["prompt_speech_tokens"],
                                      prev.speech_tokens[:n_prompt])
        np.testing.assert_array_equal(kwargs["prompt_mel"], mel[: 2 * n_prompt])


def test_launcher_spk2info(tmp_path):
    """--spk2info loads a saved registry (.npz) or a reference .pt; `default`
    is added only when the registry is empty; a missing file is an error."""
    fe = Frontend(tiny_config(), device="cpu")
    for name in ("anna", "ben"):
        fe.add_speaker(name, SpeakerInfo(embedding=np.ones(192, np.float32),
                                         prompt_speech_tokens=np.arange(4, dtype=np.int32),
                                         prompt_mel=np.zeros((8, 80), np.float32)))
    fe.save_spk2info(str(tmp_path / "reg.npz"))
    torch.save({"cara": {"llm_embedding": torch.ones(1, 192)}}, tmp_path / "reg.pt")
    Frontend(tiny_config(), device="cpu").save_spk2info(str(tmp_path / "empty.npz"))
    base = ["--tiny", "--device", "cpu", "--max-tokens", "16"]
    for path, speakers in (("reg.npz", ["anna", "ben"]), ("reg.pt", ["cara"]),
                           ("empty.npz", ["default"])):
        _, loaded = launcher.build(launcher.parse_args(base + ["--spk2info",
                                                               str(tmp_path / path)]))
        assert loaded.available_speakers() == speakers, path
    assert launcher.build(launcher.parse_args(base))[1].available_speakers() == ["default"]
    np.testing.assert_array_equal(loaded.spk2info["default"].embedding, np.zeros(192))
    with pytest.raises(FileNotFoundError):
        launcher.build(launcher.parse_args(base + ["--spk2info", str(tmp_path / "no.npz")]))
