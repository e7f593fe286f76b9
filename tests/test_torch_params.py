"""Port weight bridge and random init against the JAX package (tiny config)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config
from flowmirror_hydravox_tpu.models import flow, hift, llm
from flowmirror_hydravox_tpu.train.checkpoint import _flatten, save_params_npz
from flowmirror_hydravox_tpu_torch import params as tparams
from flowmirror_hydravox_tpu_torch.config import tiny_config as torch_tiny_config
from tests.torch_port_util import jit_o0, seeded_tiny_trees, to_numpy_tree

CFG = tiny_config()
JAX_INIT = {
    "llm": lambda k, dt: llm.init_params(k, CFG.llm, dt),
    "flow": lambda k, dt: flow.init_params(k, CFG.flow, dt),
    "hift": lambda k, dt: hift.init_params(k, CFG.hift, dt),
}
TORCH_INIT = {
    "llm": lambda g: tparams.init_llm_params(torch_tiny_config().llm, g, "cpu", torch.float32),
    "flow": lambda g: tparams.init_flow_params(torch_tiny_config().flow, g, "cpu", torch.float32),
    "hift": lambda g: tparams.init_hift_params(torch_tiny_config().hift, g, "cpu", torch.float32),
}


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX init of each tree, jitted at the lowest backend level."""
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    return {name: to_numpy_tree(jit_o0(lambda k, f=JAX_INIT[name]: f(k, jnp.float32))(k))
            for name, k in zip(("llm", "flow", "hift"), keys)}


@pytest.mark.parametrize("name", ["llm", "flow", "hift"])
def test_npz_roundtrip_keeps_keys_shapes_values(name, jax_trees, tmp_path):
    """save_params_npz (JAX) -> load_params_npz (port): exact."""
    path = str(tmp_path / f"{name}.npz")
    save_params_npz(path, jax_trees[name])
    loaded = tparams.flatten_params(tparams.load_params_npz(path, "cpu"))
    want = _flatten(jax_trees[name])
    assert set(loaded) == set(want)
    for key, arr in want.items():
        got = loaded[key].numpy()
        assert got.shape == arr.shape, key
        np.testing.assert_array_equal(got, arr, err_msg=key)


def test_npz_bf16_is_cast_back_and_noise_stays_f32(tmp_path):
    """bf16 trees are stored as f32; a bf16 load casts them back, except the
    f32 flow noise buffer."""
    tree = jit_o0(lambda k: flow.init_params(k, CFG.flow, jnp.bfloat16))(jax.random.PRNGKey(1))
    path = str(tmp_path / "flow.npz")
    save_params_npz(path, tree)
    loaded = tparams.load_params_npz(path, "cpu", dtype=torch.bfloat16)
    assert loaded["estimator"]["blocks"]["to_q"]["w"].dtype == torch.bfloat16
    assert loaded["rand_noise"].dtype == torch.float32
    np.testing.assert_array_equal(
        loaded["input_embedding"].float().numpy(),
        np.asarray(tree["input_embedding"]).astype(np.float32))


@pytest.mark.parametrize("name", ["llm", "hift"])
def test_from_numpy_tree_keeps_structure(name, jax_trees):
    tree = tparams.from_numpy_tree(jax_trees[name], "cpu")
    got = tparams.flatten_params(tree)
    want = _flatten(jax_trees[name])
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


@pytest.mark.parametrize("name", ["llm", "flow", "hift"])
def test_random_init_matches_jax_structure(name, jax_trees):
    """The port's own init: same keys, shapes, dtypes; scales in range."""
    got = tparams.flatten_params(TORCH_INIT[name](torch.Generator().manual_seed(0)))
    want = _flatten(jax_trees[name])
    assert set(got) == set(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(arr.dtype), key
        if key.endswith("rand_noise") or arr.size < 64:
            continue
        # same init scale: max |w| agrees within a factor of 2 (or both 0/1)
        g, w = float(got[key].abs().max()), float(np.abs(arr).max())
        assert (g == w) or (0.5 * w <= g <= 2.0 * w), (key, g, w)


@pytest.mark.parametrize("index,name", [(0, "llm"), (1, "flow"), (2, "hift")])
def test_seeded_tiny_trees_match_jax_init(index, name, jax_trees):
    """The seeded trees the parity tests share (torch_port_util) have the JAX
    init's keys, shapes and dtypes, and each leaf's spread: the std within a
    factor of 2 of JAX's (the LM decoder's after its deliberate x20), and no
    all-zero or constant leaf where JAX's varies, so that no path the JAX init
    exercises goes unexercised in both engines at once."""
    got = _flatten(seeded_tiny_trees()[index])
    want = _flatten(jax_trees[name])
    assert set(got) == set(want)
    for key, arr in want.items():
        g = got[key]
        assert g.shape == arr.shape and g.dtype == arr.dtype, key
        if key.endswith("rand_noise"):  # the reference buffer, held bit-exact below
            continue
        w = arr * (20.0 if key == "llm_decoder" else 1.0)
        if w.size > 1 and np.all(w == w.flat[0]):  # zeros or ones, as in JAX
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        assert np.any(g != 0) or not np.any(w != 0), key
        if w.size > 1:
            assert np.any(g != g.flat[0]), key  # varies where JAX's varies
        if w.size >= 64:  # enough draws for a spread
            g_std, w_std = float(g.std()), float(w.std())
            assert 0.5 * w_std <= g_std <= 2.0 * w_std, (key, g_std, w_std)


def test_rand_noise_is_the_reference_buffer():
    """torch.manual_seed(0); torch.randn(1, 80, 15000), bit-exact."""
    want = flow.make_rand_noise(CFG.flow)
    got = tparams.make_rand_noise(torch_tiny_config().flow)
    np.testing.assert_array_equal(got.numpy(), want)
