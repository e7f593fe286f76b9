"""Seeded requests on the port's serving routes, and the load tool that
compares them (tiny config, f32, CPU).

- A row of a flash batch drawing from its own source (`noise.RowNoise`)
  decodes the tokens of a continuous slot drawing from the same source.
- A request's `seed` gives the same audio on every route.
- tools/serve_load.py's run answers every request in both modes, and the
  seeds make both modes decode the same tokens."""

import numpy as np
import torch

from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.noise import RowNoise
from flowmirror_hydravox_tpu_torch.ops import sampling as ts
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime.continuous import ContinuousBatcher
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
from flowmirror_hydravox_tpu_torch.runtime.server import TTSService
from flowmirror_hydravox_tpu_torch.tools import serve_load
from tests.torch_port_util import seeded_tiny_trees

CFG = tiny_config()
MAX_TOKENS = 48
WAV_LSB = 2 / 32767.0
TIMEOUT = 120.0


def _engine():
    """The port's seeded tiny init, with sharper logits than the 0.02 init
    gives, so that draws are not near-uniform and rows stop apart."""
    return Engine(CFG, *(from_numpy_tree(tr, "cpu") for tr in seeded_tiny_trees()),
                  max_tokens=MAX_TOKENS, device="cpu")


def test_seeded_rows_decode_alike_on_slots_and_flash_batch():
    """A flash-batch row drawing from its own source (`RowNoise`) decodes
    the tokens that a slot drawing from the same source decodes: a seeded
    load does the same work in the window mode and on the slots."""
    engine = _engine()
    texts = [(np.arange(5 + 3 * i, dtype=np.int32) * (7 + i)) % 256 for i in range(3)]
    seeds = [31, 32, 33]
    b = ContinuousBatcher(engine, slots=3, head_num=2)
    try:
        reqs = [b.submit(t, noise=engine.noise_for(s)) for t, s in zip(texts, seeds)]
        slot_tokens = [b.result(r, timeout=TIMEOUT)[1]["tokens"] for r in reqs]
    finally:
        b.shutdown()
    padded = np.zeros((3, 32), np.int32)
    prompts = []
    for i, t in enumerate(texts):
        padded[i, :len(t)] = t
        prompts.append(tl.build_inference_prompt(
            engine.llm_params, CFG.llm, torch.as_tensor(padded[i]), len(t),
            torch.zeros((0,), dtype=torch.int32), 0))
    with torch.inference_mode():
        res = tl.generate_batched(
            engine.llm_params, CFG.llm, torch.stack([e for e, _ in prompts]),
            [n for _, n in prompts], [2 * len(t) for t in texts],
            [min(20 * len(t), MAX_TOKENS) for t in texts], ts.SamplingParams.make(),
            RowNoise(engine.noise_for(s) for s in seeds), inference_head_num=2,
            max_tokens=MAX_TOKENS, cache_len_cap=b.cache_cap)
    batch_tokens = [res.tokens[i, :n].tolist() for i, n in enumerate(res.num_tokens)]
    assert batch_tokens == slot_tokens
    assert len({len(t) for t in slot_tokens}) > 1  # the rows stop apart


def _tiny():
    return launcher.build(launcher.parse_args(["--tiny", "--device", "cpu",
                                               "--max-tokens", "32"]))


def _task(text, **extra):
    return {"type": "tts", "text": text, "speaker_id": "default", "extra_params": extra}


def test_seed_gives_the_same_audio_on_every_route():
    """Two requests with one seed coalesced into a flash batch, the same
    seed alone (`synthesize`) and on the slots: the same draws on every
    route, so the same audio (the slots' synthesis pads to TOKEN_BUCKETS,
    so there the same length)."""
    engine, frontend = _tiny()
    text = "a seeded request"
    window = TTSService(engine, frontend, request_timeout=TIMEOUT, batch_window=0.5)
    try:
        group = [window.submit(_task(text, seed=7)) for _ in range(2)]
        pair = [window.wait(tid)["output_audio"] for tid in group]
        assert window.batched_requests == 2
        alone = window.wait(window.submit(_task(text, seed=7)))["output_audio"]
        other = window.wait(window.submit(_task(text, seed=8)))["output_audio"]
    finally:
        window.shutdown()
    np.testing.assert_array_equal(pair[0], pair[1])
    np.testing.assert_allclose(alone, pair[0], atol=WAV_LSB, rtol=0)
    assert other.shape != alone.shape or np.abs(other - alone).max() > WAV_LSB
    service = TTSService(engine, frontend, request_timeout=TIMEOUT, continuous_slots=2,
                         continuous_head_num=2)
    try:
        slots = [service.wait(service.submit(_task(text, seed=7)))["output_audio"]
                 for _ in range(2)]
        assert service.continuous_requests == 2
    finally:
        service.shutdown()
    np.testing.assert_array_equal(slots[0], slots[1])
    assert slots[0].shape == alone.shape and np.isfinite(slots[0]).all()


def test_serve_load_runs_both_modes():
    """tools/serve_load.py's run on the tiny engine: both modes answer every
    request of a seeded schedule, and the slots report their step time."""
    engine, frontend = _tiny()
    gaps = [0.0, 0.05, 0.05]
    runs = {mode: serve_load.run_load(engine, frontend, mode, 2, gaps)
            for mode in ("window", "slots")}
    for mode, rec in runs.items():
        assert rec["requests"] == 3 and len(rec["latencies_s"]) == 3, mode
        assert rec["tokens"] == sum(rec["tokens_each"]) > 0, mode
        assert rec["latency_s_p95"] >= rec["latency_s_p50"] > 0 and rec["ms_per_token_p50"] > 0
    assert runs["slots"]["metrics"]["continuous_requests"] == 4  # with the warm-up
    assert runs["slots"]["batcher"]["admits"] == 3 and runs["slots"]["ms_per_slot_step"] > 0
    assert runs["window"]["metrics"]["continuous_requests"] == 0
    # the seeds make both modes decode the same tokens
    assert runs["slots"]["tokens"] == runs["window"]["tokens"]
