"""Weight-only int8 in the port against the JAX package (tiny config, CPU,
the port's seeded trees):

- `quantize_llm_params`: int8 leaves and scales bit-equal to JAX's, from an
  f32 and from a bf16 tree, with the same leaf names (`@q8scale`) and
  `quantized_fraction`; the MTP heads' q/k projections stay dense;
  `dequantize_layer_dict` bit-equal too;
- `matmul_q` against JAX's: f32 within 1e-6 (summation order), bf16 within
  one bf16 rounding of the product (rtol 8e-3 of its largest magnitude),
  dense leaves untouched;
- the plain int8 form of the MLP kernel (`mlp_gemv_ref` with scales)
  against the JAX `_mlp_block` on the quantized layer and against
  `pallas_mlp_gemv(interpret=True)` on the dequantized weights (the scales
  commute with the products): f32 atol 2e-5 / rtol 2e-4 (summation order);
  bf16 atol 3e-2 / rtol 6e-2, as tests/test_pallas_mlp.py holds the TPU
  kernel (JAX rounds each product to bf16 before its scale, the kernel's
  contract only h and the output);
- `forward_block_with_cache` (a prefill and a decode step, whose MLP takes
  the int8 form) and `mtp_logits` on the quantized tree against JAX, f32
  atol 2e-5 / rtol 2e-4;
- `Engine(quantize="int8")` against JAX `Engine(quantize="int8",
  fused=False)` under greedy sampling: tokens and steps exact, wav within
  WAV_LSB int16 steps (as tests/test_torch_engine.py); an unknown mode
  raises ValueError in both;
- a hot reload (`load_weights`, the route of /api/v1/load_pt) into an int8
  engine: the new tree is cast to the engine's dtype and quantized again,
  as JAX `set_llm_params` does (bit-equal to JAX's `quantize_llm_params` of
  the cast tree run op by op; the JAX engine jits it, and XLA's fused form
  rounds about one weight in 16k the other way), and decodes the tokens of
  a fresh int8 engine on the new tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import SamplingConfig as JaxSampling
from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.models import llm as jl
from flowmirror_hydravox_tpu.models import qwen2 as jq
from flowmirror_hydravox_tpu.ops import quant as jquant
from flowmirror_hydravox_tpu.ops.pallas_mlp import pallas_mlp_gemv
from flowmirror_hydravox_tpu.runtime.engine import Engine as JaxEngine
from flowmirror_hydravox_tpu_torch.config import SamplingConfig, tiny_config
from flowmirror_hydravox_tpu_torch.models import llm as tl
from flowmirror_hydravox_tpu_torch.models import qwen2 as tq
from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as tmlp
from flowmirror_hydravox_tpu_torch.ops import quant as tquant
from flowmirror_hydravox_tpu_torch.params import (flatten_params, from_numpy_tree,
                                                  init_llm_params)
from flowmirror_hydravox_tpu_torch.runtime.engine import Engine as TorchEngine
from tests.torch_port_util import JaxReplayNoise, n, seeded_tiny_trees, t

CFG = tiny_config()
F32 = dict(atol=2e-5, rtol=2e-4)
BF16 = dict(atol=3e-2, rtol=6e-2)
WAV_LSB = 2 / 32767.0
MAX_TOKENS = 48
GREEDY = dict(top_p=1.0, top_k=1, win_size=10, tau_r=10.0)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_numpy(tree):
    """{key: (dtype name, numpy leaf)}, bf16 leaves as f32 (exact)."""
    out = {}
    for k, v in flatten_params(tree).items():
        if isinstance(v, torch.Tensor):
            out[k] = str(v.dtype).replace("torch.", ""), v.float().numpy() if \
                v.is_floating_point() else v.numpy()
        else:
            out[k] = str(v.dtype), np.asarray(jnp.asarray(v, jnp.float32)
                                              if v.dtype == jnp.bfloat16 else v)
    return out


def _assert_bit_equal(got, want):
    got, want = _as_numpy(got), _as_numpy(want)
    assert sorted(got) == sorted(want)
    for k, (dtype, leaf) in want.items():
        assert got[k][0] == dtype, (k, got[k][0], dtype)
        np.testing.assert_array_equal(got[k][1], leaf, err_msg=k)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantized_tree_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    llm_np = seeded_tiny_trees()[0]
    want = jquant.quantize_llm_params(jax.tree.map(lambda a: jnp.asarray(a, jdt), llm_np))
    got = tquant.quantize_llm_params(from_numpy_tree(llm_np, "cpu", tdt))
    _assert_bit_equal(got, want)
    assert any(k.endswith("@q8scale") for k in flatten_params(got))
    assert got["mtp_block"]["q_proj_w"].dtype == tdt == got["mtp_block"]["k_proj_w"].dtype
    assert got["llm_decoder"].dtype == torch.int8
    assert tquant.quantized_fraction(got) == jquant.quantized_fraction(want) > 0.5
    _assert_bit_equal(tquant.dequantize_layer_dict(got["backbone"]["layers"]),
                      jquant.dequantize_layer_dict(want["backbone"]["layers"]))
    # the input tree is left as it was
    assert tquant.quantize_llm_params(got)["llm_decoder"] is got["llm_decoder"]


def test_matmul_q_matches_jax():
    rng = np.random.default_rng(0)
    w = (0.02 * rng.standard_normal((32, 48))).astype(np.float32)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    jlayer = jquant.quantize_layer_dict({"w": jnp.asarray(w)}, ["w"])
    tlayer = tquant.quantize_layer_dict({"w": t(w)}, ["w"])
    for jdt, tdt, tol in ((jnp.float32, torch.float32, dict(atol=1e-6, rtol=1e-5)),
                          (jnp.bfloat16, torch.bfloat16, None)):
        want = np.asarray(jquant.matmul_q(jnp.asarray(x, jdt), jlayer, "w"), np.float32)
        got = tquant.matmul_q(t(x).to(tdt), tlayer, "w")
        assert got.dtype == tdt
        tol = tol or dict(atol=8e-3 * np.abs(want).max(), rtol=0)
        np.testing.assert_allclose(n(got.float()), want, **tol)
    np.testing.assert_array_equal(n(tquant.matmul_q(t(x), {"w": t(w)}, "w")), x @ w)


def test_int8_mlp_plain_version_matches_jax():
    for m, i in ((5, 256), (3, 22016)):  # a backbone-like width and the MTP heads'
        _check_int8_mlp(m, 64, i)


def _check_int8_mlp(m, h, i):
    rng = np.random.default_rng(m)
    x = (0.5 * rng.standard_normal((m, h))).astype(np.float32)
    dense = {name: (0.05 * rng.standard_normal(shape)).astype(np.float32)
             for name, shape in zip(tquant.MLP_MATS, ((h, i), (h, i), (i, h)))}
    jlayer = jquant.quantize_layer_dict({k: jnp.asarray(v) for k, v in dense.items()},
                                        tquant.MLP_MATS)
    tlayer = tquant.quantize_layer_dict({k: t(v) for k, v in dense.items()}, tquant.MLP_MATS)
    weights = [tlayer[k] for k in tquant.MLP_MATS]
    got = n(tmlp.mlp_gemv_ref(t(x), *weights, tquant.mlp_scales(tlayer)))
    mlp_block = jax.jit(jq._mlp_block)  # one compile per dtype, not one per op
    np.testing.assert_allclose(got, np.asarray(mlp_block(jlayer, jnp.asarray(x))), **F32)
    deq = [np.asarray(jlayer[k], np.float32) * np.asarray(jlayer[k + "@q8scale"])
           for k in tquant.MLP_MATS]
    np.testing.assert_allclose(got, np.asarray(jax.jit(
        lambda *a: pallas_mlp_gemv(*a, tile_i=256, interpret=True))(
        jnp.asarray(x), *map(jnp.asarray, deq))), **F32)
    # bf16 activations: the kernel's contract against JAX's roundings
    got16 = tmlp.mlp_gemv_ref(t(x).to(torch.bfloat16), *weights, tquant.mlp_scales(tlayer))
    assert got16.dtype == torch.bfloat16
    want16 = mlp_block(jlayer, jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(n(got16.float()), np.asarray(want16, np.float32), **BF16)


def test_forward_and_mtp_logits_match_jax_on_int8_tree():
    """A prefill block and a decode-step block (the MLP through the int8
    form, `decode_mlp`) of the backbone, then the MTP heads and the decoder,
    all on the int8 tree."""
    llm_np = seeded_tiny_trees()[0]
    jp = jquant.quantize_llm_params(jax.tree.map(jnp.asarray, llm_np))
    tp = tquant.quantize_llm_params(from_numpy_tree(llm_np, "cpu"))
    cfg = CFG.llm.backbone
    rng = np.random.default_rng(3)
    jcache = jq.init_kv_cache(cfg, 2, 256, dtype=jnp.float32)
    tcache = tq.init_kv_cache(cfg, 2, 256, dtype=torch.float32, device="cpu")
    block = jax.jit(lambda p, x, c: jq.forward_block_with_cache(p, cfg, x, c))  # not per op
    for width, decode_step in ((9, False), (3, True)):
        x = (0.5 * rng.standard_normal((2, width, cfg.hidden_size))).astype(np.float32)
        want, jcache = block(jp["backbone"], jnp.asarray(x), jcache)
        got, tcache = tq.forward_block_with_cache(tp["backbone"], cfg, t(x), tcache,
                                                  decode_step=decode_step)
        np.testing.assert_allclose(n(got), np.asarray(want), **F32)
    hidden = np.asarray(want)[:, -1]
    np.testing.assert_allclose(
        n(tl.mtp_logits(tp, CFG.llm, t(hidden), CFG.llm.head_num)),
        np.asarray(jax.jit(lambda p, h: jl.mtp_logits(p, jax_tiny_config().llm, h,
                                                      CFG.llm.head_num))(
            jp, jnp.asarray(hidden))), **F32)


def test_int8_engine_matches_jax_under_greedy_sampling():
    trees = seeded_tiny_trees()
    jax_engine = JaxEngine(jax_tiny_config(), *trees, max_tokens=MAX_TOKENS, fused=False,
                           quantize="int8")
    engine = TorchEngine(CFG, *(from_numpy_tree(tr, "cpu") for tr in trees),
                         max_tokens=MAX_TOKENS, device="cpu", fused=False, quantize="int8")
    kwargs = dict(text_tokens=(np.arange(10, dtype=np.int32) * 13) % 256, tts_text_len=10,
                  inference_head_num=2)
    key = jax.random.PRNGKey(4)
    want = jax_engine.synthesize(rng=key, sampling=JaxSampling(**GREEDY), **kwargs)
    got = engine.synthesize(noise=JaxReplayNoise(key), sampling=SamplingConfig(**GREEDY),
                            **kwargs)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.steps == want.steps and len(got.speech_tokens) > 0
    assert got.audio.shape == want.audio.shape and np.isfinite(got.audio).all()
    np.testing.assert_allclose(got.audio, want.audio, atol=WAV_LSB, rtol=0)
    assert engine.llm_params["backbone"]["layers"]["gate_proj_w"].dtype == torch.int8


def test_unknown_quantize_mode_raises():
    trees = seeded_tiny_trees()
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        JaxEngine(jax_tiny_config(), *trees, max_tokens=MAX_TOKENS, quantize="int4")
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        TorchEngine(CFG, *(from_numpy_tree(tr, "cpu") for tr in trees), max_tokens=MAX_TOKENS,
                    device="cpu", quantize="int4")
    for mode in (None, "", "none", "bf16"):  # the dense modes keep the tree as given
        engine = TorchEngine(CFG, *(from_numpy_tree(tr, "cpu") for tr in trees),
                             max_tokens=MAX_TOKENS, device="cpu", quantize=mode)
        assert engine.llm_params["llm_decoder"].dtype == torch.float32


def test_load_weights_keeps_the_int8_policy():
    """An int8 engine built from a bf16 tree takes a reloaded f32 tree as
    JAX `set_llm_params` does: cast to bf16, then quantized (a bare cast to
    the live leaves' dtypes would truncate weights to int8 without scales);
    it then decodes the tokens of a fresh int8 engine on that tree."""
    trees = seeded_tiny_trees()
    new = jax.tree.map(lambda a: a.numpy(), init_llm_params(
        CFG.llm, torch.Generator().manual_seed(1), "cpu", torch.float32))
    new["llm_decoder"] = new["llm_decoder"] * 20.0
    dense = [from_numpy_tree(tr, "cpu", torch.bfloat16) for tr in trees[:2]] + \
            [from_numpy_tree(trees[2], "cpu")]
    engine = TorchEngine(CFG, *dense, max_tokens=MAX_TOKENS, device="cpu", quantize="int8")
    engine.load_weights({"llm": new})
    _assert_bit_equal(engine.llm_params, jquant.quantize_llm_params(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), new)))
    assert engine.llm_params["backbone"]["embed_tokens"].dtype == torch.bfloat16
    fresh = TorchEngine(CFG, from_numpy_tree(new, "cpu", torch.bfloat16), *dense[1:],
                        max_tokens=MAX_TOKENS, device="cpu", quantize="int8")
    text = (np.arange(9, dtype=np.int32) * 7) % 256
    got, want = (e.synthesize(text, 9, inference_head_num=2, noise=e.noise_for(3))
                 for e in (engine, fresh))
    assert len(got.speech_tokens) > 0
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
