"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs as numpy arrays. Random draws cannot be
reproduced across frameworks, so `JaxReplayNoise` replays the JAX package's
key chain and hands the port the exact numbers JAX draws:

  - each decode step: llm.py:369 splits (rng, rng_step); sampling.py:201
    splits rng_step into per-head keys; sampling.py:89 splits each head key
    into (rng_nuc, rng_flat); sampling.py:47 draws the Gumbel noise;
  - each flash-batch step: llm.py:463 splits (rng, rng_step); llm.py:465
    splits rng_step into per-row keys; each row's key then goes through the
    per-head chain above (the vmap at llm.py:466-471);
  - the vocoder: hift.py:228 splits the key into (rng_ini, rng_noise);
  - speculative decoding, the solo loop and a slot (one chain): the first
    token splits (rng, r0) and draws a Gumbel (V,) from r0 (llm.py:541-547);
    each step splits rng five ways (llm.py:659), r_draft again into one key
    per draft (:574), and draws the drafts' Gumbels, the accept uniforms
    from r_acc (:592), the residual's Gumbel from r_res (:603) and the
    bonus's from r_bonus (:608);
  - speculative decoding in a flash batch: r0 and each step's four keys are
    split again into B row keys first (llm.py:757-764, :785, :795,
    :812-814);
  - the flow's training loss, from the step's key itself: flow.py:223 splits
    it six ways (t, z, cfg, cond, idx, drop), dit.py:270 splits drop into one
    key per block and dit.py:202 each block key into the attention and FF
    dropout keys (a Bernoulli draw of keep = 1 - rate each); under gradient
    accumulation steps.py:153 first splits the key into one per micro-batch.

The JAX engine feeds one key to both the LM and HiFT (engine.py:1151, :1170),
so the replay starts its step chain and its vocoder draws from the same key.

Importing this module caps torch at one intra-op thread. The suite runs
several pytest-xdist workers on one host, and torch's default of one thread
per core in each of them oversubscribes the cores: a small op then waits on
threads that other workers' work has descheduled (the frontend's encoder
took ~40x longer at 8 threads than at 1 beside a running suite). The port's
test files import this module, so the cap holds in every worker that runs
one of them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def jit_o0(fn):
    """The JAX reference `fn` jitted at XLA's lowest backend optimisation
    level, compiled once per argument shape: one compile where an eager call
    compiles each op (the eager vocoder took ~13 s a case on one core), and
    a program that runs once spends most of its compile in LLVM's passes
    (the JAX init of HiFT ~18 s at the default level)."""
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), getattr(a, "dtype", None)) for a in leaves))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)

    return call


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _step_draws(rng, k, kmax, vocab):
    rng, rng_step = jax.random.split(rng)

    def head(key):
        rng_nuc, rng_flat = jax.random.split(key)
        return (jax.random.gumbel(rng_nuc, (kmax,), jnp.float32),
                jax.random.gumbel(rng_flat, (vocab,), jnp.float32))

    nuc, flat = jax.vmap(head)(jax.random.split(rng_step, k))
    return rng, nuc, flat


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _batch_step_draws(rng, b, k, kmax, vocab):
    rng, rng_step = jax.random.split(rng)

    def head(key):
        rng_nuc, rng_flat = jax.random.split(key)
        return (jax.random.gumbel(rng_nuc, (kmax,), jnp.float32),
                jax.random.gumbel(rng_flat, (vocab,), jnp.float32))

    def row(key):
        return jax.vmap(head)(jax.random.split(key, k))

    nuc, flat = jax.vmap(row)(jax.random.split(rng_step, b))
    return rng, nuc, flat


def _gumbels(keys, vocab):
    return jax.vmap(lambda key: jax.random.gumbel(key, (vocab,), jnp.float32))(keys)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _spec_first_draws(rng, b, vocab):
    """b = 0: the solo chain's (V,) draw; else the flash batch's (b, V)."""
    rng, r0 = jax.random.split(rng)
    return rng, (jax.random.gumbel(r0, (vocab,), jnp.float32) if b == 0
                 else _gumbels(jax.random.split(r0, b), vocab))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _spec_step_draws(rng, b, kd, vocab):
    """b = 0: one step of the solo chain; else a flash-batch step's B rows."""
    rng, r_draft, r_acc, r_res, r_bonus = jax.random.split(rng, 5)

    def row(rd, ra, rr, rb):
        return (_gumbels(jax.random.split(rd, kd), vocab), jax.random.uniform(ra, (kd,)),
                jax.random.gumbel(rr, (vocab,), jnp.float32),
                jax.random.gumbel(rb, (vocab,), jnp.float32))

    if b == 0:
        return rng, row(r_draft, r_acc, r_res, r_bonus)
    return rng, jax.vmap(row)(*(jax.random.split(r, b) for r in (r_draft, r_acc, r_res,
                                                                  r_bonus)))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _flow_loss_draws(rng, b, t_mel, mel_dim, depth, widths, rate):
    rng_t, rng_z, rng_cfg, rng_cond, rng_idx, rng_drop = jax.random.split(rng, 6)
    keep = None
    if rate > 0:
        keep = []
        for block in jax.random.split(rng_drop, depth):
            keys = jax.random.split(block)
            keep.append(tuple(jax.random.bernoulli(k, 1.0 - rate, (b, t_mel, w))
                              for k, w in zip(keys, widths)))
    return (jax.random.uniform(rng_t, (b, 1, 1)),
            jax.random.normal(rng_z, (b, mel_dim, t_mel)),
            jax.random.uniform(rng_cfg, (b,)), jax.random.uniform(rng_cond, (b,)),
            jax.random.uniform(rng_idx, (b,)), keep)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _vocoder_draws(rng, b, size, nh):
    """hift.py:228's (rand_ini (b, nh), noise) with the noise drawn flat, at
    `size` elements. The partitionable threefry (JAX's default) draws
    element i of any shape from counter i, so the first b x t x nh elements
    of a flat draw are the (b, t, nh) draw in row-major order: a size class
    compiles once, where each length would compile its own program."""
    rng_ini, rng_noise = jax.random.split(rng)
    return jax.random.uniform(rng_ini, (b, nh)), jax.random.normal(rng_noise, (size,))


class JaxReplayNoise:
    """A port noise source (see flowmirror_hydravox_tpu_torch/noise.py) that
    replays the JAX key chain of one synthesis started from `key`."""

    def __init__(self, key, device="cpu"):
        self.key = key
        self._rng = key
        self.device = device
        self.steps = 0

    def sampling(self, k: int, vocab: int):
        self._rng, nuc, flat = _step_draws(self._rng, k, min(64, vocab), vocab)
        self.steps += 1
        return t(nuc).to(self.device), t(flat).to(self.device)

    def sampling_batch(self, b: int, k: int, vocab: int):
        self._rng, nuc, flat = _batch_step_draws(self._rng, b, k, min(64, vocab), vocab)
        self.steps += 1
        return t(nuc).to(self.device), t(flat).to(self.device)

    def spec_first(self, vocab: int):
        self._rng, g = _spec_first_draws(self._rng, 0, vocab)
        return t(g).to(self.device)

    def spec_first_batch(self, b: int, vocab: int):
        self._rng, g = _spec_first_draws(self._rng, b, vocab)
        return t(g).to(self.device)

    def spec_step(self, kd: int, vocab: int):
        self._rng, draws = _spec_step_draws(self._rng, 0, kd, vocab)
        self.steps += 1
        return tuple(t(d).to(self.device) for d in draws)

    def spec_step_batch(self, b: int, kd: int, vocab: int):
        self._rng, draws = _spec_step_draws(self._rng, b, kd, vocab)
        self.steps += 1
        return tuple(t(d).to(self.device) for d in draws)

    def vocoder(self, b: int, length: int, nh: int):
        assert jax.config.jax_threefry_partitionable, "flat draws need the partitionable threefry"
        size = b * length * nh
        ri, rn = _vocoder_draws(self.key, b, 1 << max(size - 1, 1).bit_length(), nh)
        rn = np.asarray(rn)[:size].reshape(b, length, nh)
        return t(ri).to(self.device), t(rn).to(self.device)

    def flow_loss(self, b: int, t_mel: int, mel_dim: int, depth: int, widths, rate: float):
        from flowmirror_hydravox_tpu_torch.noise import FlowDraws

        *draws, keep = _flow_loss_draws(self.key, b, t_mel, mel_dim, depth, tuple(widths),
                                        float(rate))
        if keep is not None:
            keep = [tuple(t(m).to(self.device) for m in pair) for pair in keep]
        return FlowDraws(*(t(d).to(self.device) for d in draws), keep)

    def split(self, k: int):
        return [JaxReplayNoise(key, self.device) for key in jax.random.split(self.key, k)]


@functools.lru_cache(maxsize=None)
def seeded_tiny_trees():
    """(llm, flow, hift) numpy trees of `tiny_config()` in the JAX layout, f32,
    from the port's seeded init (torch seed 0; the JAX init of flow and HiFT
    takes tens of seconds on the CPU), with the LM decoder scaled by 20 so
    that draws are not near-uniform. Built once per process and shared by the
    files that run there; callers copy before they modify."""
    from flowmirror_hydravox_tpu_torch.config import tiny_config
    from flowmirror_hydravox_tpu_torch.params import (init_flow_params, init_hift_params,
                                                      init_llm_params)

    gen = torch.Generator().manual_seed(0)
    cfg = tiny_config()
    trees = [jax.tree.map(lambda a: a.numpy(), init(sub, gen, "cpu", torch.float32))
             for init, sub in ((init_llm_params, cfg.llm), (init_flow_params, cfg.flow),
                               (init_hift_params, cfg.hift))]
    trees[0]["llm_decoder"] = trees[0]["llm_decoder"] * 20.0
    return tuple(trees)


def t(x, dtype=None):
    """numpy -> CPU tensor."""
    out = torch.from_numpy(np.array(x))  # a writable copy
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
