"""Weight-only int8 (`--quantize int8`) on every serving route of the port
(tiny config, CPU, the port's seeded f32 trees): each route at int8 decodes
the tokens that the port's int8 solo route (`Engine.synthesize`) decodes on
the same seeds, as tests/test_torch_seeded_serving.py and
tests/test_torch_spec_serving.py hold the dense routes. The solo route
itself is held against JAX in tests/test_torch_quant.py.

- the flash batch (`synthesize_batch`, one source a row: `RowNoise`);
- a stream on the lane (`synthesize_stream`, its decode source the solo
  request's);
- the continuous slots, one request admitted while another decodes, and a
  stream riding them;
- speculative decoding on an int8 engine: solo, the flash batch and the
  spec slots;
- the launcher's `--quantize` and `HYDRAVOX_QUANTIZE`, a `TTSService` on
  2 int8 slots, and `HydraVox(quantize="int8")` (whole and streamed);
- `/api/v1/load_pt` into a 2-slot int8 server while a slot decodes: the
  live tree is the new checkpoint's, quantized (int8 leaves with their
  scales), and decodes the tokens of a fresh int8 engine on it;
- tools/eval_int8.py on the CPU: its JSON line, and every token of a tree
  held against itself agreeing; JAX's command line (`--text_len`, the
  `--tiny` clamps) and every field of JAX's JSON line."""

import ast
import contextlib
import json
import pathlib
import threading
import urllib.request

import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.api import HydraVox
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.convert import torch_import
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.noise import RowNoise, SeededVocoder, StreamNoise
from flowmirror_hydravox_tpu_torch.ops import quant
from flowmirror_hydravox_tpu_torch.ops.sampling import SamplingParams
from flowmirror_hydravox_tpu_torch.params import (flatten_params, from_numpy_tree,
                                                  init_llm_params)
from flowmirror_hydravox_tpu_torch.runtime.continuous import ContinuousBatcher
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
from flowmirror_hydravox_tpu_torch.runtime.server import TTSService, make_server
from flowmirror_hydravox_tpu_torch.tools import eval_int8
from tests.torch_port_util import seeded_tiny_trees

CFG = tiny_config()
MAX_TOKENS = 48
TIMEOUT = 120.0
TEXTS = [(np.arange(n, dtype=np.int32) * mul + 1) % 256 for n, mul in ((14, 5), (6, 9), (10, 13))]
SEEDS = [21, 22, 23]


def _engine(spec_decode=False):
    return Engine(CFG, *(from_numpy_tree(tr, "cpu") for tr in seeded_tiny_trees()),
                  max_tokens=MAX_TOKENS, device="cpu", quantize="int8", spec_decode=spec_decode)


@pytest.fixture(scope="module")
def int8_engine():
    return _engine()


@pytest.fixture(scope="module")
def int8_spec_engine():
    return _engine(spec_decode=True)


def _solo(engine, text, seed, heads):
    res = engine.synthesize(text, len(text), inference_head_num=heads,
                            noise=engine.noise_for(seed))
    return res.speech_tokens.tolist()


@contextlib.contextmanager
def _recorded_batches(monkeypatch):
    """The tokens of each row of every flash-batch decode while entered."""
    rows = []

    def record(fn):
        def wrapped(*args, **kwargs):
            res = fn(*args, **kwargs)
            out = res.result if isinstance(res, tl.SpecResult) else res
            rows.extend(out.tokens[i, :k].tolist() for i, k in enumerate(out.num_tokens))
            return res
        return wrapped

    for name in ("generate_batched", "generate_batched_speculative"):
        monkeypatch.setattr(tl, name, record(getattr(tl, name)))
    yield rows


def _batcher_tokens(engine, heads, spec=False):
    """Each text on 2 slots, the first tick driven by hand so that the
    third request joins while the others decode, and a stream of the first
    text; returns (tokens of each request, the stream's tokens)."""
    sp = CFG.tts_sampling  # the solo route's default, as the server gives its slots
    b = ContinuousBatcher(engine, slots=2, head_num=heads, spec_decode=spec,
                          sampling=SamplingParams.make(sp.top_p, sp.top_k, sp.win_size, sp.tau_r))
    try:
        b._started, b._state = True, b._init_state()  # the thread waits for the first tick
        reqs = [b.submit(t, noise=engine.noise_for(s)) for t, s in zip(TEXTS[:2], SEEDS)]
        b._tick()
        reqs.append(b.submit(TEXTS[2], noise=engine.noise_for(SEEDS[2])))
        b._thread.start()
        tokens = [b.result(r, timeout=TIMEOUT)[1]["tokens"] for r in reqs]
        stream = b.submit(TEXTS[0], stream=True, noise=StreamNoise(
            engine.noise_for(SEEDS[0]), SeededVocoder(1, "cpu")))
        chunks = list(b.stream_result(stream, timeout=TIMEOUT))
        assert chunks and all(np.isfinite(c).all() for c in chunks)
        return tokens, stream.stats["tokens"]
    finally:
        b.shutdown()


def test_int8_flash_batch_and_lane_match_solo(int8_engine, monkeypatch):
    solo = [_solo(int8_engine, t, s, 2) for t, s in zip(TEXTS, SEEDS)]
    assert len({len(s) for s in solo}) > 1  # the rows stop apart
    with _recorded_batches(monkeypatch) as rows:
        wavs, stats = int8_engine.synthesize_batch(
            TEXTS, inference_head_num=2,
            noise=RowNoise(int8_engine.noise_for(s) for s in SEEDS))
    assert rows == solo and stats["tokens"] == [len(s) for s in solo]
    assert all(len(w) > 0 and np.isfinite(w).all() for w in wavs)
    session = {}
    chunks = list(int8_engine.streaming().synthesize_stream(
        TEXTS[0], len(TEXTS[0]), inference_head_num=2, session=session,
        noise=StreamNoise(int8_engine.noise_for(SEEDS[0]), SeededVocoder(1, "cpu"))))
    assert session["tokens"] == solo[0]
    assert chunks and all(np.isfinite(c).all() for c in chunks)


def test_int8_slots_match_solo(int8_engine):
    solo = [_solo(int8_engine, t, s, 2) for t, s in zip(TEXTS, SEEDS)]
    tokens, stream = _batcher_tokens(int8_engine, 2)
    assert tokens == solo and stream == solo[0]


def test_int8_spec_routes_match_solo(int8_spec_engine, monkeypatch):
    """Speculative decoding at heads 3 on the int8 tree: the flash batch
    and the spec slots decode the spec solo route's tokens."""
    engine = int8_spec_engine
    solo = [_solo(engine, t, s, 3) for t, s in zip(TEXTS, SEEDS)]
    with _recorded_batches(monkeypatch) as rows:
        _, stats = engine.synthesize_batch(TEXTS, inference_head_num=3,
                                           noise=RowNoise(engine.noise_for(s) for s in SEEDS))
    assert rows == solo and stats["spec_acceptance"] >= 0
    tokens, stream = _batcher_tokens(engine, 3, spec=True)
    assert tokens == solo and stream == solo[0]


def test_launcher_quantize_flag_and_env(monkeypatch):
    monkeypatch.delenv("HYDRAVOX_QUANTIZE", raising=False)
    assert launcher.parse_args([]).quantize is None
    monkeypatch.setenv("HYDRAVOX_QUANTIZE", "int8")
    assert launcher.parse_args([]).quantize == "int8"
    assert launcher.parse_args(["--quantize", "bf16"]).quantize == "bf16"
    with pytest.raises(SystemExit):
        launcher.parse_args(["--quantize", "int4"])
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", "32"]))  # int8 from the environment
    assert engine.quantize == "int8"
    assert engine.llm_params["backbone"]["layers"]["q_proj_w"].dtype == torch.int8
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=2,
                         continuous_head_num=2)
    try:
        tids = [service.submit({"type": "tts", "text": text, "speaker_id": "default",
                                "extra_params": {}})
                for text in ("int8 on the slots", "The first part! And a second one.")]
        for res in (service.wait(tid) for tid in tids):
            assert res["sample_rate"] == 24000 and len(res["output_audio"]) > 0, res
        assert service.continuous_requests == 2 and service.batcher.stats["admits"] == 3
    finally:
        service.shutdown()


def test_hydravox_serves_int8():
    hv = HydraVox(tiny=True, device="cpu", max_tokens=32, quantize="int8")
    assert hv.engine.llm_params["llm_decoder"].dtype == torch.int8
    (whole,) = hv.inference_sft("an int8 voice", "default")
    chunks = [c["tts_speech"] for c in hv.inference_sft("an int8 stream", "default",
                                                        stream=True)]
    assert whole["sample_rate"] == 24000 and len(whole["tts_speech"]) > 0
    assert chunks and all(len(c) > 0 and np.isfinite(c).all() for c in chunks)


def test_load_pt_into_int8_server(tmp_path):
    """/api/v1/load_pt while a slot decodes on an int8 server: the request
    in flight finishes, the live tree is the new llm.pt's cast to the
    engine's dtype and quantized, and the same seed then decodes the tokens
    of a fresh int8 engine on that checkpoint."""
    engine = _engine()
    frontend = launcher.build(launcher.parse_args(["--tiny", "--device", "cpu"]))[1]
    other = init_llm_params(CFG.llm, torch.Generator().manual_seed(1), "cpu", torch.float32)
    other["llm_decoder"] = other["llm_decoder"] * 20.0
    torch.save(torch_import.reference_state_dict("llm", other, CFG), tmp_path / "llm.pt")
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=300.0,
                         continuous_slots=2, continuous_head_num=2)
    batcher = server.RequestHandlerClass.service.batcher
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        in_flight = batcher.submit(TEXTS[0], noise=engine.noise_for(5))
        body = {"llm_pt": str(tmp_path / "llm.pt")}
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/api/v1/load_pt",
            json.dumps(body).encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200 and json.load(r)["data"] == {"llm": body["llm_pt"]}
        wav, _ = batcher.result(in_flight, timeout=300)
        assert len(wav) > 0 and np.isfinite(wav).all()
        new_tree = from_numpy_tree(torch_import.convert(
            "llm", torch_import.load_torch_pt(body["llm_pt"]), CFG), "cpu", torch.float32)
        want = flatten_params(quant.quantize_llm_params(new_tree))
        live = flatten_params(engine.llm_params)
        assert live.keys() == want.keys()
        assert all(torch.equal(live[k], want[k]) for k in want)
        assert live["backbone.layers.down_proj_w@q8scale"].dtype == torch.float32
        after = batcher.result(batcher.submit(TEXTS[0], noise=engine.noise_for(5)),
                               timeout=300)[1]["tokens"]
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
    fresh = Engine(CFG, new_tree, engine.flow_params, engine.hift_params, max_tokens=MAX_TOKENS,
                   device="cpu", quantize="int8")
    assert after == _solo(fresh, TEXTS[0], 5, 2)


def test_eval_int8_runs_on_cpu(capsys):
    out = eval_int8.main(["--tiny", "--device", "cpu", "--utterances", "2", "--tokens", "24",
                          "--text_len", "8"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["probes"] == 4 and len(out["kl_dense_int8_per_head"]) == CFG.llm.head_num
    assert 0 < out["greedy_token_agreement"] <= 1 and max(out["kl_dense_int8_per_head"]) >= 0
    dense = from_numpy_tree(seeded_tiny_trees()[0], "cpu")
    same = eval_int8.evaluate(CFG.llm, dense, dense, utterances=1, tokens=16, text_len=8,
                              device="cpu")
    assert same["greedy_seq_match"] == "1/1" and same["kl_bf16_int8_max"] == 0.0


def _jax_eval_int8_fields() -> set:
    """The keys of the dict JAX's tools/eval_int8.py prints, read from its
    source (running it would compile the JAX engine twice)."""
    src = pathlib.Path(__file__).resolve().parents[1] / "flowmirror_hydravox_tpu" / "tools" / \
        "eval_int8.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out"
                and isinstance(node.value, ast.Call)):
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no `out = dict(...)` in JAX's eval_int8")


def test_eval_int8_takes_jax_flags_and_fields(capsys):
    jax_fields = _jax_eval_int8_fields()
    assert {"kl_bf16_int8_mean", "kl_bf16_int8_max", "top1_agreement",
            "first_divergence_tokens"} <= jax_fields
    out = eval_int8.main(["--tiny", "--device", "cpu", "--utterances", "1", "--tokens", "64",
                          "--text_len", "40"])
    assert (out["tokens"], out["text_len"]) == (32, 16)  # JAX's --tiny clamps
    assert jax_fields <= out.keys()
    assert out["first_divergence_tokens"] is None or isinstance(out["first_divergence_tokens"],
                                                                  int)
    assert out["kl_bf16_int8_mean"] == pytest.approx(np.mean(out["kl_dense_int8_per_head"]),
                                                     abs=1e-6)
    assert 0 <= out["kl_bf16_int8_mean"] <= out["kl_bf16_int8_max"]
    assert out["top1_agreement"] == round(float(np.mean(out["top1_agreement_per_head"])), 4)
