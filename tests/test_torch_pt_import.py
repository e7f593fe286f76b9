"""The reference's .pt checkpoints in the port (tiny config, CPU):

- `convert/torch_import.py` against the JAX package's converter on one
  synthetic state dict in the reference key layout (HiFT's convs as
  weight-norm pairs in both torch layouts): the same trees at f32;
- `Engine.synthesize` on the port's loaded trees against the JAX engine on
  its own converted trees (both `fused=True`, the default), the same key;
- `build(--model-dir)` with .pt files serves those weights (npz first when
  both are there), the text vocab taken from llm.pt;
- `POST /api/v1/load_pt` swaps weights into a live 2-slot server between two
  of its batcher's ticks while a request decodes.

The synthetic state dict is the port's seeded tiny trees written out by
`torch_import.reference_state_dict`; JAX's converter is the judge of its
layout."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.convert import torch_import as jax_import
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.convert import torch_import
from flowmirror_hydravox_tpu_torch.params import (flatten_params, from_numpy_tree,
                                                  init_llm_params)
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from flowmirror_hydravox_tpu_torch.runtime.server import make_server
from tests.torch_port_util import JaxReplayNoise, seeded_tiny_trees

CFG = tiny_config()
NAMES = ("llm", "flow", "hift")
WAV_LSB = 2 / 32767.0
MAX_TOKENS = 48
JAX_CONVERT = {"llm": lambda sd: jax_import.llm_from_state_dict(sd, jax_tiny_config().llm),
               "flow": lambda sd: jax_import.flow_from_state_dict(sd, jax_tiny_config().flow),
               "hift": lambda sd: jax_import.hift_from_state_dict(sd, jax_tiny_config().hift)}


def _state_dict(name, tree, vocab=None):
    """`tree` (numpy, JAX layout) in the reference key layout, as tensors;
    `vocab` pads an LLM's text embedding to that many rows."""
    tree = from_numpy_tree(tree, "cpu")
    if vocab is not None:
        emb = tree["backbone"]["embed_tokens"]
        extra = torch.randn((vocab - emb.shape[0], emb.shape[1]), generator=torch.Generator()
                            .manual_seed(3)) * 0.02
        tree["backbone"]["embed_tokens"] = torch.cat([emb, extra])
    return torch_import.reference_state_dict(name, tree, CFG)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """llm.pt / flow.pt / hift.pt of the seeded tiny trees (text vocab padded
    to 384) in a directory of their own."""
    root = tmp_path_factory.mktemp("pt")
    for name, tree in zip(NAMES, seeded_tiny_trees()):
        torch.save(_state_dict(name, tree, vocab=384 if name == "llm" else None),
                   root / f"{name}.pt")
    return root


def _assert_trees_equal(got, want):
    """Same keys, and leaves equal as f32."""
    def f32(x):
        return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    got, want = flatten_params(got), flatten_params(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(f32(got[k]), f32(want[k]), err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_converter_matches_jax(checkpoints, name):
    sd = torch_import.load_torch_pt(str(checkpoints / f"{name}.pt"))
    _assert_trees_equal(sd, jax_import.load_torch_pt(str(checkpoints / f"{name}.pt")))
    if name == "hift":  # both weight-norm layouts are there
        assert any(k.endswith(".weight_g") for k in sd)
        assert any(k.endswith(".parametrizations.weight.original0") for k in sd)
        assert not any(k.endswith(".weight") and "conv" in k for k in sd)
    _assert_trees_equal(torch_import.convert(name, sd, CFG), JAX_CONVERT[name](sd))


def test_synthesize_on_pt_weights_matches_jax(checkpoints):
    sds = {name: jax_import.load_torch_pt(str(checkpoints / f"{name}.pt")) for name in NAMES}
    jax_engine = JaxEngine(jax_tiny_config(), *(JAX_CONVERT[name](sds[name]) for name in NAMES),
                           max_tokens=MAX_TOKENS)
    torch_engine = TorchEngine(CFG, *(torch_import.load_tree(str(checkpoints / f"{name}.pt"),
                                                             name, CFG, "cpu", torch.float32)
                                      for name in NAMES), max_tokens=MAX_TOKENS, device="cpu")
    kwargs = dict(text_tokens=(np.arange(9, dtype=np.int32) * 29) % 300, tts_text_len=9,
                  inference_head_num=2)
    key = jax.random.PRNGKey(11)
    want = jax_engine.synthesize(rng=key, **kwargs)
    got = torch_engine.synthesize(noise=JaxReplayNoise(key), **kwargs)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.audio.shape == want.audio.shape and len(got.audio) > 0
    np.testing.assert_allclose(got.audio, want.audio, atol=WAV_LSB, rtol=0)


def test_build_serves_pt_weights(checkpoints, tmp_path):
    """Only .pt files: the served trees are the converter's at the serving
    dtypes (LLM and flow bf16, HiFT f32) and the text vocab is llm.pt's; a
    .npz beside a .pt wins."""
    args = ["--tiny", "--device", "cpu", "--max-tokens", "16", "--model-dir"]
    engine, _ = launcher.build(launcher.parse_args(args + [str(checkpoints)]))
    assert engine.cfg.llm.backbone.vocab_size == 384
    for name, dtype in zip(NAMES, (torch.bfloat16, torch.bfloat16, torch.float32)):
        served = getattr(engine, f"{name}_params")
        want = from_numpy_tree(torch_import.convert(
            name, torch_import.load_torch_pt(str(checkpoints / f"{name}.pt")), engine.cfg),
            "cpu", dtype)
        assert {t.dtype for k, t in flatten_params(served).items() if k != "rand_noise"} == {dtype}
        assert all(t.is_contiguous() for t in flatten_params(served).values())  # as kernels need
        _assert_trees_equal(served, want)
    both = tmp_path / "both"
    both.mkdir()
    for name in NAMES:
        (both / f"{name}.pt").write_bytes((checkpoints / f"{name}.pt").read_bytes())
    hift = jax.tree.map(lambda a: a + 1.0, seeded_tiny_trees()[2])
    np.savez(both / "hift.npz", **{k: np.asarray(v) for k, v in flatten_params(hift).items()})
    engine, _ = launcher.build(launcher.parse_args(args + [str(both)]))
    _assert_trees_equal(engine.hift_params, hift)


def test_load_pt_route_swaps_between_ticks(checkpoints, tmp_path):
    """/api/v1/load_pt while a slot decodes: the request in flight finishes,
    the live trees become the new checkpoint's at the live dtypes, and the
    same seed then decodes other tokens."""
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", str(MAX_TOKENS), "--model-dir",
         str(checkpoints)]))
    other = init_llm_params(CFG.llm, torch.Generator().manual_seed(1), "cpu", torch.float32)
    other["llm_decoder"] = other["llm_decoder"] * 20.0
    other["backbone"]["embed_tokens"] = torch.randn((384, CFG.llm.backbone.hidden_size)) * 0.02
    torch.save(torch_import.reference_state_dict("llm", other, CFG), tmp_path / "llm.pt")
    server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=300.0,
                         continuous_slots=2, continuous_head_num=2)
    batcher = server.RequestHandlerClass.service.batcher
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        text = (np.arange(12, dtype=np.int32) * 17) % 300
        before = batcher.result(batcher.submit(text, noise=engine.noise_for(5)), timeout=300)[1]
        in_flight = batcher.submit(text, noise=engine.noise_for(5))
        body = {"llm_pt": str(tmp_path / "llm.pt"), "flow_pt": str(checkpoints / "flow.pt")}
        url = f"http://127.0.0.1:{server.server_address[1]}/api/v1/load_pt"
        req = urllib.request.Request(url, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert (r.status, json.load(r)) == (200, {"success": True, "message": "loaded",
                                                      "data": {"llm": body["llm_pt"],
                                                               "flow": body["flow_pt"]},
                                                      "error": None})
        wav, _ = batcher.result(in_flight, timeout=300)
        assert len(wav) > 0 and np.isfinite(wav).all()
        _assert_trees_equal(engine.llm_params, from_numpy_tree(
            torch_import.convert("llm", torch_import.load_torch_pt(body["llm_pt"]), engine.cfg),
            "cpu", torch.bfloat16))
        after = batcher.result(batcher.submit(text, noise=engine.noise_for(5)), timeout=300)[1]
        assert after["tokens"] != before["tokens"]
    finally:
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
