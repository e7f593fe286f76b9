"""The port's HTTP server on the CPU (tiny config, random weights): the SFT
REST schema, its error codes, the launcher's device rule, and the JAX
server's routes: a multi-segment text as one flash batch, and window
coalescing of concurrent requests. Around it: tools/loadgen.py against the
JAX package's copy on one server, and the web UI (`--with-ui`) against the
JAX page."""

import ast
import base64
import io
import json
import pathlib
import threading
import urllib.error
import urllib.request
import wave

import contextlib

import numpy as np
import pytest
import torch

from chip_smoke import ui_api_calls, ui_sets
from flowmirror_hydravox_tpu.runtime import webui as jax_webui
from flowmirror_hydravox_tpu.tools import loadgen as jax_loadgen
from flowmirror_hydravox_tpu_torch import __main__ as launcher
import tests.torch_port_util  # noqa: F401  (one torch thread per test worker)
from flowmirror_hydravox_tpu_torch.runtime import webui
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
from flowmirror_hydravox_tpu_torch.runtime.server import TTSService, make_server
from flowmirror_hydravox_tpu_torch.tools import loadgen

JAX_ROOT = pathlib.Path(__file__).resolve().parents[1] / "flowmirror_hydravox_tpu"
NOT_FOUND = {"success": False, "message": "not found", "data": None, "error": "not found"}

TWO_SEGMENTS = "The first sentence is here! And a second one follows."


@pytest.fixture(scope="module")
def tiny():
    args = launcher.parse_args(["--tiny", "--device", "cpu", "--max-tokens", "32"])
    return launcher.build(args)


@pytest.fixture(scope="module")
def server_url(tiny):
    engine, frontend = tiny
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=300.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.RequestHandlerClass.service.shutdown()
    server.server_close()


def _call(url, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_health_and_speakers(server_url):
    assert _call(f"{server_url}/health") == (200, {"status": "ok"})
    code, body = _call(f"{server_url}/api/v1/speakers")
    assert code == 200 and body["success"] and body["data"]["speakers"] == ["default"]


@pytest.mark.parametrize("text,heads", [("hello there world", 1), (TWO_SEGMENTS, 2)])
def test_tts_returns_24k_wav(server_url, text, heads):
    code, body = _call(f"{server_url}/api/v1/tts", {
        "text": text, "speaker_id": "default", "extra_params": {"inference_head_num": heads}})
    assert code == 200 and body["success"], body
    with wave.open(io.BytesIO(base64.b64decode(body["data"]["audio_base64"]))) as w:
        assert w.getframerate() == 24000 and w.getnchannels() == 1 and w.getsampwidth() == 2
        assert w.getnframes() > 0
    assert body["data"]["sample_rate"] == 24000 and body["data"]["duration"] > 0


def test_error_codes(server_url):
    code, body = _call(f"{server_url}/api/v1/tts", {"text": "hi", "speaker_id": "nobody"})
    assert code == 500 and not body["success"] and "default" in body["error"]
    code, body = _call(f"{server_url}/api/v1/tts", raw=b"{not json")
    assert code == 400 and not body["success"]
    assert _call(f"{server_url}/api/v1/nowhere")[0] == 404
    assert _call(f"{server_url}/api/v1/nowhere", {"x": 1})[0] == 404


def test_cuda_entry_point_raises_without_a_gpu():
    """Asking for the card where there is none raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(None, {}, {}, {}, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.build(launcher.parse_args(["--tiny"]))


@contextlib.contextmanager
def _service(tiny, monkeypatch, batch_window, fail_batch=False):
    """A TTSService on the tiny engine whose engine calls are recorded:
    (method, rows or speed, result)."""
    engine, frontend = tiny
    calls = []
    synthesize, synthesize_batch = engine.synthesize, engine.synthesize_batch

    def record_one(**kwargs):
        res = synthesize(**kwargs)
        calls.append(("synthesize", kwargs["speed"], res))
        return res

    def record_batch(token_lists, **kwargs):
        if fail_batch:
            raise RuntimeError("the batch failed")
        wavs, stats = synthesize_batch(token_lists, **kwargs)
        calls.append(("synthesize_batch", [list(r) for r in token_lists], wavs))
        return wavs, stats

    monkeypatch.setattr(engine, "synthesize", record_one)
    monkeypatch.setattr(engine, "synthesize_batch", record_batch)
    service = TTSService(engine, frontend, request_timeout=300.0, batch_window=batch_window)
    try:
        yield service, calls
    finally:
        service.shutdown()


def _task(text, speed=1.0, heads=2):
    return {"type": "tts", "text": text, "speaker_id": "default",
            "extra_params": {"inference_head_num": heads, "speed": speed}}


@pytest.mark.parametrize("speed", [1.0, 1.2])
def test_multi_segment_text_is_one_flash_batch(tiny, monkeypatch, speed):
    """The JAX server's route (server.py:697-719): one synthesize_batch with a
    row per segment and no synthesize call, at any speed (the flash batch
    takes none)."""
    _, frontend = tiny
    with _service(tiny, monkeypatch, batch_window=0.0) as (service, calls):
        result = service.wait(service.submit(_task(TWO_SEGMENTS, speed=speed)))
    segments = frontend.text_normalize(TWO_SEGMENTS, split=True)
    assert len(segments) == 2
    assert [c[0] for c in calls] == ["synthesize_batch"]
    assert calls[0][1] == [list(frontend.extract_text_tokens(s)) for s in segments]
    wavs = calls[0][2]
    audio = result["output_audio"]
    assert len(audio) > sum(len(w) for w in wavs)  # a pause between the segments
    np.testing.assert_array_equal(audio[:len(wavs[0])], wavs[0])
    np.testing.assert_array_equal(audio[-len(wavs[1]):], wavs[1])


def test_window_coalesces_concurrent_requests(tiny, monkeypatch):
    """Three requests queued within the window are one flash batch of three
    rows; each gets its own row back."""
    _, frontend = tiny
    texts = ["hello there world", "a second short request", "and the third one"]
    with _service(tiny, monkeypatch, batch_window=1.0) as (service, calls):
        tids = [service.submit(_task(text)) for text in texts]
        results = [service.wait(tid) for tid in tids]
        assert service.batched_requests == 3
    assert [c[0] for c in calls] == ["synthesize_batch"]
    assert calls[0][1] == [list(frontend.extract_text_tokens(x)) for x in texts]
    for res, wav in zip(results, calls[0][2]):
        assert res["sample_rate"] == 24000 and len(wav) > 0
        np.testing.assert_array_equal(res["output_audio"], wav)


def test_speed_request_is_not_coalesced(tiny, monkeypatch):
    """A speed != 1 request ends the window and runs right after the group,
    in arrival order; the request behind it runs on its own."""
    with _service(tiny, monkeypatch, batch_window=0.5) as (service, calls):
        tids = [service.submit(_task(text, speed=speed)) for text, speed in
                (("hello there world", 1.0), ("a slower request", 1.2), ("the last one", 1.0))]
        results = [service.wait(tid) for tid in tids]
        assert service.batched_requests == 0
    assert [(c[0], c[1]) for c in calls] == [("synthesize", 1.0), ("synthesize", 1.2),
                                             ("synthesize", 1.0)]
    assert all(len(r["output_audio"]) > 0 for r in results)


def test_failed_group_answers_each_request_with_the_error(tiny, monkeypatch):
    with _service(tiny, monkeypatch, batch_window=1.0, fail_batch=True) as (service, calls):
        tids = [service.submit(_task(text)) for text in ("one request", "two", "three")]
        results = [service.wait(tid) for tid in tids]
        assert service.batched_requests == 0
    assert results == [{"error": "the batch failed"}] * 3
    assert calls == []


def jax_flags(path: pathlib.Path) -> set:
    """The option strings of every add_argument in a JAX source file."""
    return {a.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)}


@pytest.mark.parametrize("mode,arrival", [("tts", "closed"), ("stream", "poisson")])
def test_loadgen_matches_jax_loadgen(server_url, capsys, mode, arrival):
    """One command line, every flag of JAX's loadgen, through both copies
    against one port server: the same fields, every request answered."""
    argv = ["--url", server_url, "--speaker", "default", "--text", "hello there world",
            "--mode", mode, "--arrival", arrival, "--rate", "4", "--concurrency", "2",
            "--duration", "1.5", "--head-num", "2", "--timeout", "120", "--warmup", "1"]
    assert {a for a in argv if a.startswith("--")} == jax_flags(JAX_ROOT / "tools" / "loadgen.py")
    jax_loadgen.main(argv)
    jax_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = loadgen.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out.keys() == jax_out.keys()
    for res in (jax_out, out):
        assert res["requests"] > 0 and res["errors"] == 0, res
        assert (res["mode"], res["arrival"]) == (mode, arrival)
        assert res["latency_p95_ms"] >= res["latency_p50_ms"] > 0
        assert (res["ttft_p50_ms"] is not None) == (mode == "stream")
        assert res["batched_requests"] is not None and res["continuous_requests"] == 0


def test_web_ui_page_and_routes(tiny, server_url):
    """The port's page against JAX's, served at GET / with `with_ui` (and
    not without), and every route the page calls served by the port (a
    route's own 404 for an unknown id counts; the unknown-route 404 does
    not)."""
    page, jax_page = webui.INDEX_HTML, jax_webui.INDEX_HTML
    sets = ui_sets(page)
    assert sets, "I18N table not found"
    assert sets["tabs"] == {"tts", "zeroshot", "data", "training", "models", "speakers"}
    assert sets["en"] == sets["zh"] and len(sets["en"]) > 30 and sets["markers"] <= sets["en"]
    assert sets == ui_sets(jax_page)
    calls = ui_api_calls(page)
    assert calls == ui_api_calls(jax_page)
    assert {path for path, _ in calls} == {
        "/speakers", "/speakers/add", "/speakers/remove/", "/tts", "/samples", "/samples/load",
        "/zero-shot", "/devices", "/data/run", "/training/start", "/training/status/",
        "/training/stop/", "/models/list", "/models/delete", "/models/convert", "/load_pt"}
    assert launcher.parse_args(["--with-ui"]).with_ui and not launcher.parse_args([]).with_ui

    with urllib.request.urlopen(server_url + "/", timeout=60) as r:
        assert json.load(r) == {"status": "ok"}
    engine, frontend = tiny
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=300.0, with_ui=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert r.headers["Content-Type"] == "text/html; charset=utf-8"
            assert r.read().decode("utf-8") == page
        assert _call(base + "/health") == (200, {"status": "ok"})
        for path, method in calls + [("/training/plot/", "GET")]:
            url = base + "/api/v1" + path + ("no-such-id" if path.endswith("/") else "")
            code, body = _call(url, {} if method == "POST" else None)
            assert body != NOT_FOUND, (path, method, code)
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
