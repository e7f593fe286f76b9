"""Zero-shot on the port's batched routes (tiny config, f32, CPU):

- `Engine.synthesize_batch` with zero-shot, cross-lingual and SFT rows mixed
  (per-row prompts, LM prefixes and tts-portion lengths) against the JAX
  `Engine.synthesize_batch` at the same rows and key (both `fused=True`):
  tokens exact, the same stage-2 bucket, wavs within WAV_LSB int16 steps,
  and the zero-shot row's mel within 1e-3;
- window coalescing: a zero-shot, a cross-lingual and an SFT request in one
  flash batch, each row carrying its LM prefix and tts-portion length
  (server.py:848-895);
- the slots (server.py:797-826, :906-913): plain zero-shot at the slots'
  sampling rides them, with the tokens `Engine.synthesize` decodes on the
  same seed; cross-lingual, instruct2 and zero-shot at its own default
  sampling take the worker;
- a stream for a speaker registered from audio: on the stream lane the PCM
  of `synthesize_stream` on that speaker's features, on the slots within
  two int16 steps of it (tests/test_torch_streaming.py holds prompted
  streams to the JAX streamer, tests/test_torch_frontend.py the registered
  speaker's features to the JAX frontend)."""

import contextlib
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from flowmirror_hydravox_tpu_torch.runtime.server import (DEFAULT_TTS_EXTRA, DEFAULT_ZS_EXTRA,
                                                          TTSService, make_server)
from tests.test_torch_speech_tokenizer import voiced
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

WAV_LSB = 2 / 32767.0
MAX_TOKENS = 48
TIMEOUT = 300.0
PROMPT = voiced(16000, 1.5, 30)
SFT_EMB = np.random.default_rng(4).standard_normal(192).astype(np.float32)


@pytest.fixture(scope="module")
def frontend():
    return Frontend(tiny_config(), device="cpu")


def _mixed_rows(frontend):
    """(zero-shot, cross-lingual, SFT) rows as the server builds them."""
    zs = frontend.frontend_zero_shot("A new line to speak.", "Hi there.", PROMPT, 16000)
    xl = frontend.frontend_cross_lingual("Say it in another tongue.", PROMPT, 16000)
    sft = dict(text_tokens=frontend.extract_text_tokens("Plain speech here."),
               spk_embedding=SFT_EMB)
    sft["tts_text_len"] = len(sft["text_tokens"])
    return [zs, xl, sft]


def test_mixed_flash_batch_matches_jax(frontend):
    trees = seeded_tiny_trees()
    jax_engine = JaxEngine(jax_tiny_config(), *trees, max_tokens=MAX_TOKENS)
    torch_engine = TorchEngine(tiny_config(), *(from_numpy_tree(tr, "cpu") for tr in trees),
                               max_tokens=MAX_TOKENS, device="cpu")
    rows = _mixed_rows(frontend)
    assert len(rows[0]["prompt_speech_tokens"]) > 20
    assert len(rows[1]["llm_prompt_speech_tokens"]) == 0
    kwargs = dict(text_tokens_list=[r["text_tokens"] for r in rows], inference_head_num=2,
                  prompt_speech_tokens=[r.get("prompt_speech_tokens") for r in rows],
                  prompt_mel=[r.get("prompt_mel") for r in rows],
                  spk_embedding=np.stack([r["spk_embedding"] for r in rows]),
                  tts_text_lens=[r["tts_text_len"] for r in rows],
                  llm_prompt_speech_tokens=[r.get("llm_prompt_speech_tokens") for r in rows])
    key = jax.random.PRNGKey(21)
    want_wavs, want = jax_engine.synthesize_batch(rng=key, **kwargs)
    got_wavs, got = torch_engine.synthesize_batch(noise=JaxReplayNoise(key), **kwargs)
    assert got["tokens"] == want["tokens"] and got["steps"] == want["steps"]
    assert rows[0]["tts_text_len"] < len(rows[0]["text_tokens"])  # the prompt text is left out
    fused = [k for k in jax_engine._gen_cache if k[0] == "fused_batch"]
    assert got["estimated"] and [k[5] for k in fused] == [got["token_bucket"]]
    for g, w in zip(got_wavs, want_wavs):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g, w, atol=WAV_LSB, rtol=0)

    # the zero-shot row's mel, through each engine's one-row flow + HiFT body
    zs, n_tok, bkt = rows[0], got["tokens"][0], got["token_bucket"]
    lp, lm = len(zs["prompt_speech_tokens"]), len(zs["prompt_mel"])
    sp_pad, pm = np.zeros((64,), np.int32), np.zeros((1, 128, 80), np.float32)
    sp_pad[:lp], pm[0, :lm] = zs["prompt_speech_tokens"], zs["prompt_mel"]
    tokens = np.zeros((MAX_TOKENS,), np.int32)
    with torch.inference_mode():
        res = torch_engine._synth_body(bkt, 128, 64, torch.as_tensor(tokens)[None], [n_tok],
                                       torch.as_tensor(sp_pad)[None], [lp], torch.as_tensor(pm),
                                       [lm], torch.as_tensor(zs["spk_embedding"])[None],
                                       JaxReplayNoise(key))
    _, want_mel = jax.jit(jax_engine._synth_body(bkt, 128, 64))(
        jax_engine.flow_params, jax_engine.hift_params, jnp.asarray(tokens), jnp.int32(n_tok),
        jnp.asarray(sp_pad), jnp.int32(lp), jnp.asarray(pm), jnp.int32(lm),
        jnp.asarray(zs["spk_embedding"])[None], key)
    np.testing.assert_allclose(res[1].numpy(), np.asarray(want_mel), atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", "32"]))
    frontend.add_speaker_from_audio("clone", PROMPT, 16000, prompt_text="Hi there.")
    return engine, frontend


@contextlib.contextmanager
def _recorded(engine, name):
    """Each call of `engine.<name>` as (args, kwargs, result)."""
    calls, inner = [], getattr(engine, name)

    def record(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(engine, name, record)
    try:
        yield calls
    finally:
        setattr(engine, name, inner)


def _zs_task(mode, **extra):
    return {"type": "zero_shot", "tts_text": "One more line to say.", "prompt_text": "Hi there.",
            "prompt_audio": PROMPT, "prompt_sample_rate": 16000, "mode": mode,
            "extra_params": {**DEFAULT_ZS_EXTRA, **extra}}


def test_window_coalesces_zero_shot_rows(tiny):
    """A zero-shot, a cross-lingual and an SFT request at one sampling ride
    one flash batch: each row with its prompt, LM prefix and tts length."""
    engine, frontend = tiny
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, batch_window=0.5)
    sft = {"type": "tts", "text": "Plain speech here.", "speaker_id": "default",
           "extra_params": dict(DEFAULT_ZS_EXTRA)}
    try:
        with _recorded(engine, "synthesize_batch") as calls:
            tids = [service.submit(t) for t in (_zs_task("zero_shot", seed=1),
                                                _zs_task("cross_lingual", seed=2), sft)]
            results = [service.wait(tid) for tid in tids]
        assert service.batched_requests == 3
    finally:
        service.shutdown()
    assert len(calls) == 1
    (rows,), kwargs, (wavs, _) = calls[0]
    zs = frontend.frontend_zero_shot("One more line to say.", "Hi there.", PROMPT, 16000)
    np.testing.assert_array_equal(rows[0], zs["text_tokens"])
    assert kwargs["tts_text_lens"] == [zs["tts_text_len"], len(rows[1]), len(rows[2])]
    lm = kwargs["llm_prompt_speech_tokens"]
    assert lm[0] is None and len(lm[1]) == 0 and lm[2] is None
    np.testing.assert_array_equal(kwargs["prompt_speech_tokens"][1], zs["prompt_speech_tokens"])
    assert kwargs["prompt_speech_tokens"][2] is None
    for result, wav in zip(results, wavs):
        np.testing.assert_array_equal(result["output_audio"], wav)


def test_slots_take_plain_zero_shot_and_send_the_rest_to_the_worker(tiny):
    engine, frontend = tiny
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=2,
                         continuous_head_num=2)
    slot_reqs, submit = [], service.batcher.submit
    service.batcher.submit = lambda *a, **kw: slot_reqs.append(submit(*a, **kw)) or slot_reqs[-1]
    win = DEFAULT_TTS_EXTRA["win_size"]
    try:
        with _recorded(engine, "synthesize") as calls:
            slot = service.wait(service.submit(_zs_task("zero_shot", win_size=win, seed=9)))
            assert service.continuous_requests == 1 and not calls
            for mode, extra in (("cross_lingual", dict(win_size=win)),
                                ("instruct2", dict(win_size=win)), ("zero_shot", {})):
                assert "output_audio" in service.wait(service.submit(_zs_task(mode, **extra)))
            assert service.continuous_requests == 1 and len(calls) == 3
            assert [c[1]["llm_prompt_speech_tokens"] is None for c in calls] == [False, False, True]
    finally:
        service.shutdown()
    (req,) = slot_reqs
    zs = frontend.frontend_zero_shot("One more line to say.", "Hi there.", PROMPT, 16000)
    np.testing.assert_array_equal(req.text_tokens, zs["text_tokens"])
    np.testing.assert_array_equal(req.prompt_speech_tokens, zs["prompt_speech_tokens"])
    assert req.max_len == min(20 * zs["tts_text_len"], 32)
    alone = engine.synthesize(zs["text_tokens"], zs["tts_text_len"],
                              sampling=service._sampling({**DEFAULT_ZS_EXTRA, "win_size": win}),
                              inference_head_num=2,
                              prompt_speech_tokens=zs["prompt_speech_tokens"],
                              prompt_mel=zs["prompt_mel"], spk_embedding=zs["spk_embedding"],
                              noise=engine.noise_for(9))
    assert req.stats["tokens"] == alone.speech_tokens.tolist()
    assert len(slot["output_audio"]) == len(alone.audio)


def _stream_pcm(url, body):
    req = urllib.request.Request(url + "/api/v1/tts/stream", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return np.frombuffer(r.read()[44:], "<i2").astype(np.int32)


@pytest.mark.parametrize("slots", [0, 2], ids=["lane", "slots"])
def test_registered_speaker_stream(tiny, slots):
    engine, frontend = tiny
    text = "Speak as the clone now."
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=TIMEOUT,
                         continuous_slots=slots)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        got = _stream_pcm(f"http://127.0.0.1:{server.server_address[1]}",
                          {"text": text, "speaker_id": "clone", "extra_params": {"seed": 4}})
        assert server.RequestHandlerClass.service.continuous_requests == (1 if slots else 0)
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
    feats = frontend.frontend_sft(frontend.text_normalize(text, split=True)[0], "clone")
    assert len(feats["prompt_speech_tokens"]) > 20 and len(feats["prompt_mel"]) > 0
    want = np.concatenate(list(engine.streaming().synthesize_stream(
        feats["text_tokens"], feats["tts_text_len"], inference_head_num=2,
        prompt_speech_tokens=feats["prompt_speech_tokens"], prompt_mel=feats["prompt_mel"],
        spk_embedding=feats["spk_embedding"], noise=engine.stream_noise(4))))
    want = (np.clip(want, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.int32)
    assert got.shape == want.shape and len(got) > 0
    assert np.abs(got - want).max() <= (0 if slots == 0 else 2)
