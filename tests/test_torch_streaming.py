"""The port's streaming synthesis against the JAX package (tiny config, f32).

- The DiT's static-chunk mask and the flow's three streaming forms (an
  exact-shape finalize=False call, a bucket-padded call with `emit_valid`,
  finalize=True on the streaming mask) within TOL of JAX.
- `fade_in_out` and `_bucket_chunk` equal to JAX's.
- `synthesize_stream` against the JAX `StreamingSynthesizer` at
  token_hop_len 8, mel_cache_len 4 (as tests/test_streaming.py runs it), the
  port's decode and vocoder sources replaying the two keys the JAX streamer
  splits its key into: the same chunks of the same lengths, the same token
  prefix for every chunk (exact), the PCM within PCM_STEPS int16 steps. Three
  sessions: an SFT stream at heads 2 (the fused first chunk's int16 rule), a
  stream with prompt speech tokens and a prompt mel (prompt_pad 2), and one
  whose max_len cuts the first chunk's target (the unfused first chunk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import dit as jdit
from flowmirror_hydravox_tpu.models import flow as jflow
from flowmirror_hydravox_tpu.runtime import streaming as jstreaming
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch.models import dit as tdit
from flowmirror_hydravox_tpu_torch.models import flow as tflow
from flowmirror_hydravox_tpu_torch.noise import StreamNoise
from flowmirror_hydravox_tpu_torch.params import from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime import streaming as tstreaming
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from tests.torch_port_util import JaxReplayNoise, n, seeded_tiny_trees, t

CFG = tiny_config()
MAX_TOKENS = 48
TOL = 1e-5
PCM_STEPS = 2
TEXT = (np.arange(10, dtype=np.int32) * 13) % 256
CASES = {
    "sft_heads2": dict(inference_head_num=2),
    "prompted": dict(
        inference_head_num=2,
        prompt_speech_tokens=np.arange(6, dtype=np.int32) * 7 % 50,
        prompt_mel=np.random.default_rng(0).standard_normal((12, 80)).astype(np.float32),
        spk_embedding=np.random.default_rng(1).standard_normal(192).astype(np.float32)),
    "first_target_capped": dict(inference_head_num=3, max_token_text_ratio=1.0),
}


@pytest.fixture(scope="module")
def engines():
    """The JAX engine (default ladders) and the port's on the same f32
    weights, the port's seeded init in the JAX layout (the JAX init of HiFT
    and flow takes half a minute on the CPU)."""
    trees = seeded_tiny_trees()  # sharper logits than the 0.02 init gives
    jax_engine = JaxEngine(CFG, *trees, max_tokens=MAX_TOKENS, fused=False)
    torch_engine = TorchEngine(CFG, *(from_numpy_tree(tr, "cpu") for tr in trees),
                               max_tokens=MAX_TOKENS, device="cpu")
    return jax_engine, torch_engine


def _record_chunks(synth):
    """Record each `_token2wav` call's (token prefix, token_offset, finalize)."""
    calls, inner = [], synth._token2wav

    def token2wav(tokens, prompt_tokens, prompt_mel, emb, token_offset, rng, finalize,
                  hift_cache, *rest):
        calls.append((np.asarray(tokens).tolist(), int(token_offset), bool(finalize)))
        return inner(tokens, prompt_tokens, prompt_mel, emb, token_offset, rng, finalize,
                     hift_cache, *rest)

    synth._token2wav = token2wav
    return calls


@pytest.fixture(scope="module")
def streams(engines):
    """Each case once through both streamers: {case: (jax, port)}, each
    (chunks, recorded chunk calls), the port's with its session record."""
    jax_engine, torch_engine = engines
    # one JAX streamer for every case: it holds nothing but its jit caches,
    # so the cases that share a chunk's shapes share its programs
    js = jstreaming.StreamingSynthesizer(jax_engine, token_hop_len=8, mel_cache_len=4)
    out = {}
    for i, (case, kwargs) in enumerate(CASES.items()):
        key = jax.random.PRNGKey(11 + i)
        ts = tstreaming.StreamingSynthesizer(torch_engine, token_hop_len=8, mel_cache_len=4)
        jcalls, tcalls = _record_chunks(js), _record_chunks(ts)
        want = list(js.synthesize_stream(TEXT, len(TEXT), rng=key, **kwargs))
        del js._token2wav  # the next case records its own calls
        rng, hift_rng = jax.random.split(key)
        session = {}
        got = list(ts.synthesize_stream(
            TEXT, len(TEXT), noise=StreamNoise(JaxReplayNoise(rng), JaxReplayNoise(hift_rng)),
            session=session, **kwargs))
        out[case] = (want, jcalls), (got, tcalls, session)
    return out


def test_dit_streaming_mask_matches_jax(engines):
    jax_engine, torch_engine = engines
    ecfg = CFG.flow.estimator
    rng = np.random.default_rng(0)
    b, tt = 2, 120  # three static chunks of 50 frames
    x = rng.standard_normal((b, 80, tt)).astype(np.float32)
    mu = rng.standard_normal((b, ecfg.mu_dim, tt)).astype(np.float32)
    cond = rng.standard_normal((b, 80, tt)).astype(np.float32)
    spks = rng.standard_normal((b, ecfg.spk_dim)).astype(np.float32)
    tt_ = np.array([0.1, 0.7], np.float32)
    mask = np.ones((b, 1, tt), np.float32)
    mask[0, :, 10:60] = 0  # chunk 0's queries keep only frames 0-9
    mask[1, :, 31:] = 0  # rows with no key: the finite NEG_INF bias, as in JAX
    args = (x, mask, mu, tt_, spks, cond)
    want = jax.jit(lambda p, *a: jdit.forward(p, ecfg, *a, streaming=True))(  # one compile
        jax_engine.flow_params["estimator"], *map(jnp.asarray, args))
    got = tdit.forward(torch_engine.flow_params["estimator"], ecfg, *map(t, args),
                       streaming=True)
    assert np.isfinite(n(got)).all()
    np.testing.assert_allclose(n(got), n(want), atol=TOL, rtol=0)
    plain = tdit.forward(torch_engine.flow_params["estimator"], ecfg, *map(t, args))
    assert np.abs(n(plain) - n(got)).max() > 1e-3  # the mask changed the estimate


@pytest.mark.parametrize("form", ["exact_shape", "emit_valid", "finalize"])
def test_flow_streaming_forms_match_jax(engines, form):
    jax_engine, torch_engine = engines
    fcfg = CFG.flow
    rng = np.random.default_rng(1)
    t_tok = 64
    token = rng.integers(0, fcfg.vocab_size, (1, t_tok)).astype(np.int32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    pm_len = 10
    prompt = np.zeros((1, 16, 80), np.float32)
    prompt[0, :pm_len] = rng.standard_normal((pm_len, 80))
    n_valid = t_tok if form == "exact_shape" else 57
    valid = (np.arange(t_tok) < n_valid)[None]
    emit = (np.arange(t_tok) < n_valid - fcfg.pre_lookahead_len)[None]
    use_emit = form == "emit_valid"
    finalize = form == "finalize"
    want = jax.jit(lambda p, *a, emit_valid: jflow.inference(  # one compile, not one per op
        p, fcfg, *a, finalize=finalize, streaming=True, emit_valid=emit_valid))(
        jax_engine.flow_params, jnp.asarray(token), jnp.asarray(valid), jnp.asarray(prompt),
        jnp.int32(pm_len), jnp.asarray(emb), emit_valid=jnp.asarray(emit) if use_emit else None)
    got = tflow.inference(
        torch_engine.flow_params, fcfg, t(token), t(valid), t(prompt), pm_len, t(emb),
        finalize=finalize, streaming=True, emit_valid=t(emit) if use_emit else None)
    assert got.shape == want.shape
    assert got.shape[2] == (t_tok - (fcfg.pre_lookahead_len if form == "exact_shape" else 0)) * 2
    np.testing.assert_allclose(n(got), n(want), atol=TOL, rtol=0)


def test_fade_and_chunk_buckets_match_jax():
    rng = np.random.default_rng(2)
    window = np.hamming(2 * 48)
    a, b = (rng.standard_normal(200).astype(np.float32) for _ in range(2))
    got = tstreaming.fade_in_out(a, b, window)
    np.testing.assert_array_equal(got, jstreaming.fade_in_out(a, b, window))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[48:], a[48:])
    for size in (1, 50, 64, 65, 128, 129, 700, 2048, 5000):
        assert tstreaming._bucket_chunk(size) == jstreaming._bucket_chunk(size), size


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax_streamer(streams, case):
    (want, jcalls), (got, tcalls, session) = streams[case]
    assert [len(c) for c in got] == [len(c) for c in want] and len(got) >= 1
    # the JAX fused first chunk calls no _token2wav: its tokens are the
    # prefix of the later chunks'
    fused = len(tcalls) - len(jcalls)
    assert fused in (0, 1) and tcalls[fused:] == jcalls
    if fused:
        first = tcalls[0][0]
        assert tcalls[0][1:] == (0, False) and first == tcalls[-1][0][:len(first)]
    assert session["tokens"] == tcalls[-1][0] and session["steps"] > 0
    assert len(session["chunks"]) == len(got)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        g16, w16 = ((np.clip(x, -1, 1) * 32767.0).astype(np.int16).astype(np.int32)
                    for x in (g, w))
        assert np.abs(g16 - w16).max() <= PCM_STEPS
    samples = CFG.flow.token_mel_ratio * CFG.hift.upsample_scale
    assert sum(len(c) for c in got) == len(session["tokens"]) * samples


def test_stream_cases_take_their_first_chunk_paths(streams):
    """The SFT and prompted sessions yield a first chunk before any
    `_token2wav` of JAX's (the fused program, int16 rule); the capped one
    has no such chunk, and the prompted one's first chunk ends on a hop
    multiple of prompt + generated tokens."""
    for case, fused in (("sft_heads2", True), ("prompted", True), ("first_target_capped", False)):
        (want, jcalls), (got, tcalls, _) = streams[case]
        assert (len(jcalls) == len(want) - 1) == fused, case
        assert (len(tcalls) == len(got)), case
    (_, _), (_, tcalls, _) = streams["prompted"]
    assert tcalls[0][1] == 0 and (6 + len(tcalls[0][0]) - 3) % 8 == 0
