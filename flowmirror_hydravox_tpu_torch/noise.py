"""Noise for one synthesis.

The port's functions that draw take their noise as tensors. A noise source
hands them out in the order the JAX package draws it:

  - `sampling(k, vocab)`: one decode step's Gumbel noise, (nucleus (k, KMAX),
    flat (k, vocab)) f32, one row per MTP head;
  - `sampling_batch(b, k, vocab)`: one flash-batch step's, (nucleus
    (b, k, KMAX), flat (b, k, vocab)) f32, per batch row and head;
  - `vocoder(b, t, nh)`: the NSF source's (rand_ini (b, nh) uniform [0, 1),
    noise (b, t, nh) standard normal) f32;
  - speculative decoding (models/llm.py): `spec_first(vocab)`, the first
    token's Gumbel (vocab,) (llm.py:541-547), and `spec_step(kd, vocab)`,
    one step's (draft Gumbels (kd, vocab), accept uniforms (kd,), residual
    Gumbel (vocab,), bonus Gumbel (vocab,)) (llm.py:659, :574, :592, :603,
    :608); `spec_first_batch(b, vocab)` and `spec_step_batch(b, kd, vocab)`
    the same with a leading axis of b flash-batch rows;
  - flow training (models/flow.py `compute_loss`): `flow_loss(b, t_mel,
    mel_dim, depth, widths, rate)`, one loss's `FlowDraws` in the JAX order
    (flow.py:223-258): t (b, 1, 1) and the uniforms cfg, cond and idx (b,)
    U[0, 1), z (b, mel_dim, t_mel) standard normal, and for each of the
    `depth` blocks the keep masks of its attention output and FF hidden,
    (b, t_mel, w) for w in `widths`, each element kept with probability
    1 - rate (None at rate 0); `split(k)` gives the k sources of k
    micro-batches under gradient accumulation (JAX steps.py:153).

`TorchNoise` draws from a `torch.Generator` on the device, for serving. Tests
use a source that replays the JAX key chain instead, so that both packages see
the same numbers. `RowNoise` gives each row of a flash batch a source of its
own, so that a row draws what the same source would give it on a continuous
slot (or alone): its draws therefore differ from the JAX flash batch's,
which splits each step's key again into B row keys (llm.py:463-465 and, for
speculative decoding, :757-764, :785, :795, :812-814). The parity tests
replay that split for a flash batch fed one source, not a `RowNoise`.
`StreamNoise` is a stream's pair of sources: its decode draws continue, and
its vocoder draws restart from one seed on every chunk (`SeededVocoder`).
"""

from __future__ import annotations

import torch

from typing import NamedTuple, Optional

from .ops.sampling import nucleus_kmax

_TINY = torch.finfo(torch.float32).tiny


class FlowDraws(NamedTuple):
    t: torch.Tensor  # (B, 1, 1) U[0, 1)
    z: torch.Tensor  # (B, mel_dim, T_mel) N(0, 1)
    cfg: torch.Tensor  # (B,) U[0, 1): a row keeps its conditions when > training_cfg_rate
    cond: torch.Tensor  # (B,) U[0, 1): a row gets a mel-prefix condition when >= 0.5
    idx: torch.Tensor  # (B,) U[0, 1): the prefix length, as a share of 0.3 x feat_len
    keep: Optional[list]  # per block (attention, FF) bool keep masks, or None


class TorchNoise:
    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def _gumbel(self, shape):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return -torch.log(-torch.log(torch.clamp_min(u, _TINY)))

    def sampling(self, k: int, vocab: int):
        return self._gumbel((k, nucleus_kmax(vocab))), self._gumbel((k, vocab))

    def sampling_batch(self, b: int, k: int, vocab: int):
        return self._gumbel((b, k, nucleus_kmax(vocab))), self._gumbel((b, k, vocab))

    def spec_first(self, vocab: int):
        return self._gumbel((vocab,))

    def spec_step(self, kd: int, vocab: int):
        return (self._gumbel((kd, vocab)),
                torch.rand((kd,), generator=self.generator, device=self.device),
                self._gumbel((vocab,)), self._gumbel((vocab,)))

    def spec_first_batch(self, b: int, vocab: int):
        return self._gumbel((b, vocab))

    def spec_step_batch(self, b: int, kd: int, vocab: int):
        return (self._gumbel((b, kd, vocab)),
                torch.rand((b, kd), generator=self.generator, device=self.device),
                self._gumbel((b, vocab)), self._gumbel((b, vocab)))

    def vocoder(self, b: int, t: int, nh: int):
        rand_ini = torch.rand((b, nh), generator=self.generator, device=self.device)
        noise = torch.randn((b, t, nh), generator=self.generator, device=self.device)
        return rand_ini, noise

    def _uniform(self, *shape):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def flow_loss(self, b: int, t_mel: int, mel_dim: int, depth: int, widths, rate: float):
        t = self._uniform(b, 1, 1)
        z = torch.randn((b, mel_dim, t_mel), generator=self.generator, device=self.device)
        cfg, cond, idx = self._uniform(b), self._uniform(b), self._uniform(b)
        keep = None
        if rate > 0:
            keep = [tuple(self._uniform(b, t_mel, w) < 1.0 - rate for w in widths)
                    for _ in range(depth)]
        return FlowDraws(t, z, cfg, cond, idx, keep)

    def split(self, k: int):
        """k micro-batches draw one after another from this generator."""
        return [self] * k


class RowNoise:
    """One source per batch row: row r's draws are `sources[r]`'s one-row
    draws, stacked."""

    def __init__(self, sources):
        self.sources = list(sources)

    def _rows(self, b: int):
        if b != len(self.sources):
            raise ValueError(f"{len(self.sources)} row sources for a batch of {b}")
        return self.sources

    def sampling_batch(self, b: int, k: int, vocab: int):
        nuc, flat = zip(*(s.sampling(k, vocab) for s in self._rows(b)))
        return torch.stack(nuc), torch.stack(flat)

    def spec_first_batch(self, b: int, vocab: int):
        return torch.stack([s.spec_first(vocab) for s in self._rows(b)])

    def spec_step_batch(self, b: int, kd: int, vocab: int):
        return tuple(torch.stack(d) for d in zip(*(s.spec_step(kd, vocab)
                                                    for s in self._rows(b))))

    def vocoder(self, b: int, t: int, nh: int):
        rand_ini, noise = zip(*(s.vocoder(1, t, nh) for s in self._rows(b)))
        return torch.cat(rand_ini), torch.cat(noise)


class SeededVocoder:
    """A vocoder source that redraws from `seed` on every call, so the same
    shape gets the same draw each time, as a JAX key that every chunk of a
    stream reuses does (streaming.py:255)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def vocoder(self, b: int, t: int, nh: int):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return TorchNoise(gen).vocoder(b, t, nh)


class StreamNoise:
    """A stream's two sources, as the JAX streamer splits its key once into a
    decode key and a vocoder key (streaming.py:316): `sampling` and the spec
    draws continue `decode`, and `vocoder` comes from `vocoder_source`,
    which must redraw from one key on every call (`SeededVocoder`, or a
    replayed JAX key)."""

    def __init__(self, decode, vocoder_source):
        self.decode = decode
        self.vocoder_source = vocoder_source

    def sampling(self, k: int, vocab: int):
        return self.decode.sampling(k, vocab)

    def spec_first(self, vocab: int):
        return self.decode.spec_first(vocab)

    def spec_step(self, kd: int, vocab: int):
        return self.decode.spec_step(kd, vocab)

    def vocoder(self, b: int, t: int, nh: int):
        return self.vocoder_source.vocoder(b, t, nh)
