"""Repetition-aware sampling (RAS), port of
flowmirror_hydravox_tpu/ops/sampling.py.

Torch cannot reproduce `jax.random`, so every function that draws takes its
Gumbel noise as tensors (see noise.py): the nucleus draw takes (..., KMAX),
the flat fallback draw takes (..., V). Functions work on a leading head axis
where the JAX package vmapped over heads.

Ties: `lax.top_k` breaks ties toward the lower index, so the port ranks with
a stable descending sort, which does the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SamplingParams(NamedTuple):
    top_p: float
    top_k: int
    win_size: int
    tau_r: float

    @staticmethod
    def make(top_p=0.8, top_k=25, win_size=10, tau_r=0.1) -> "SamplingParams":
        return SamplingParams(float(top_p), int(top_k), int(win_size), float(tau_r))

    @property
    def repeat_threshold(self) -> float:
        # f32 product, as the JAX package computes it
        return float(np.float32(self.win_size) * np.float32(self.tau_r))


# Nucleus candidates come from at most KMAX top tokens: exact for every
# top_k <= KMAX (production top_k is <= 25).
NUCLEUS_KMAX = 64


def nucleus_kmax(vocab: int) -> int:
    return min(NUCLEUS_KMAX, vocab)


def _gumbel_argmax(log_probs, gumbel):
    return torch.argmax(log_probs + gumbel, dim=-1)


def _top_k(probs, k: int):
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nucleus_sample(logits, top_p: float, top_k: int, gumbel):
    """Sample from the reference's nucleus set (common.py:146-161).
    logits (..., V); gumbel (..., KMAX). Returns (...,) int64 token ids."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    kmax = nucleus_kmax(probs.shape[-1])
    top_vals, top_idx = _top_k(probs, kmax)
    excl_cum = torch.cumsum(top_vals, dim=-1) - top_vals
    rank = torch.arange(kmax, device=logits.device)
    keep = (excl_cum < top_p) & (rank < min(top_k, kmax))
    kept_logp = torch.where(keep, torch.log(torch.clamp_min(top_vals, 1e-30)), -torch.inf)
    pick = _gumbel_argmax(kept_logp, gumbel)
    return torch.gather(top_idx, -1, pick[..., None])[..., 0]


def _in_window(history, num_decoded, win_size: int):
    """Positions of the last `win_size` decoded tokens. `num_decoded` is an
    int, or a tensor that broadcasts against history's last axis."""
    pos = torch.arange(history.shape[-1], device=history.device)
    return (pos < num_decoded) & (pos >= num_decoded - win_size)


def _ras_candidate(logits, token_history, num_decoded, params: SamplingParams,
                   ignore_eos, speech_token_size: int, gumbel_nuc):
    """Nucleus-candidate phase of a RAS step for (..., V) logits; the history
    (..., L) and `num_decoded` broadcast against the logits' leading axes.
    Returns (candidate, repeated, masked_logits)."""
    v = logits.shape[-1]
    is_stop = torch.arange(v, device=logits.device) >= speech_token_size
    ignore = torch.as_tensor(ignore_eos, device=logits.device)[..., None]
    masked = torch.where(ignore & is_stop, -torch.inf, logits.to(torch.float32))
    candidate = nucleus_sample(masked, params.top_p, params.top_k, gumbel_nuc)
    in_window = _in_window(token_history, num_decoded, params.win_size)
    rep_num = torch.sum(in_window & (token_history == candidate[..., None]), dim=-1)
    repeated = rep_num.to(torch.float32) >= params.repeat_threshold
    return candidate, repeated, masked


def ras_sample(logits, token_history, num_decoded: int, params: SamplingParams,
               ignore_eos: bool, speech_token_size: int, gumbel_nuc, gumbel_flat):
    """Full RAS step for one head: logits (V,) -> scalar token id."""
    candidate, repeated, masked = _ras_candidate(
        logits, token_history, num_decoded, params, ignore_eos, speech_token_size, gumbel_nuc)
    flat = _gumbel_argmax(torch.log_softmax(masked, dim=-1), gumbel_flat)
    return torch.where(repeated, flat, candidate)


def ras_dist(logits, token_history, num_decoded: int, params: SamplingParams,
             ignore_eos: bool, speech_token_size: int):
    """Exact marginal distribution of `ras_sample` as a (V,) vector:
    P(x) = P_nuc(x) [not repeated(x)] + (sum_c P_nuc(c) repeated(c)) P_flat(x)."""
    return ras_dist_rows(logits, token_history, torch.as_tensor(num_decoded), params,
                         torch.as_tensor(ignore_eos), speech_token_size)


def ras_dist_rows(logits, token_history, num_decoded, params: SamplingParams, ignore_eos,
                  speech_token_size: int):
    """`ras_dist` for rows at once, one per draft or verify position, each
    with its own `num_decoded` and `ignore_eos`: the JAX vmaps over positions
    (llm.py:571-574, :589-591) and over batch rows, written out as leading
    axes. logits (..., V); token_history (..., L), broadcasting against the
    logits' leading axes; num_decoded and ignore_eos tensors of (or
    broadcasting to) the leading shape. Returns (..., V) f32."""
    v = logits.shape[-1]
    dev = logits.device
    is_stop = torch.arange(v, device=dev) >= speech_token_size
    ignore = torch.as_tensor(ignore_eos, device=dev)[..., None]
    masked = torch.where(ignore & is_stop, -torch.inf, logits.to(torch.float32))
    probs = torch.softmax(masked, dim=-1)

    kmax = nucleus_kmax(v)
    top_vals, top_idx = _top_k(probs, kmax)
    excl_cum = torch.cumsum(top_vals, dim=-1) - top_vals
    keep = (excl_cum < params.top_p) & (torch.arange(kmax, device=dev) < min(params.top_k, kmax))
    kept = torch.where(keep, top_vals, 0.0)
    p_nuc_top = kept / torch.clamp_min(torch.sum(kept, dim=-1, keepdim=True), 1e-30)
    p_nuc = torch.zeros_like(probs).scatter_add_(-1, top_idx, p_nuc_top)

    lead = probs.shape[:-1]
    hist = token_history.to(dev).expand(*lead, token_history.shape[-1])
    num = torch.as_tensor(num_decoded, device=dev).expand(lead)[..., None]
    in_window = _in_window(hist, num, params.win_size)
    counts = torch.zeros_like(probs).scatter_add_(
        -1, torch.clamp(hist, 0, v - 1).long(), in_window.to(torch.float32))
    repeated = counts >= params.repeat_threshold
    fallback_mass = torch.sum(torch.where(repeated, p_nuc, 0.0), dim=-1, keepdim=True)
    return torch.where(repeated, 0.0, p_nuc) + fallback_mass * probs


def sample_dist(dist, gumbel):
    """Categorical draw from explicit probability vectors (..., V), one
    Gumbel row each. Returns (...,) int64."""
    return _gumbel_argmax(torch.log(torch.clamp_min(dist, 1e-30)), gumbel)


def ras_sample_heads(head_logits, token_history, num_decoded: int, params: SamplingParams,
                     min_len: int, speech_token_size: int, gumbel_nuc, gumbel_flat):
    """Sample all K MTP heads against the same history snapshot
    (llm_multi_head_v3.py:890-900). Head j ignores EOS iff
    num_decoded + j < min_len. head_logits (K, V), gumbel_nuc (K, KMAX),
    gumbel_flat (K, V). Returns (K,) int64.

    The repetition fallback takes a head's flat draw where its candidate
    repeated, as the JAX package's hoisted `lax.cond` does; here both draws
    are computed every step, since on the card a branch would cost a host
    synchronisation and the values are the same."""
    k = head_logits.shape[0]
    ignore = (num_decoded + torch.arange(k, device=head_logits.device)) < min_len
    cands, reps, maskeds = _ras_candidate(
        head_logits, token_history, num_decoded, params, ignore, speech_token_size, gumbel_nuc)
    flats = _gumbel_argmax(torch.log_softmax(maskeds, dim=-1), gumbel_flat)
    return torch.where(reps, flats, cands)


def ras_sample_heads_batched(head_logits, token_history, num_decoded, params: SamplingParams,
                             min_len, speech_token_size: int, gumbel_nuc, gumbel_flat):
    """`ras_sample_heads` for B rows at once, each against its own history,
    `num_decoded` and `min_len`: the JAX vmap over rows (llm.py:466-471),
    written out as a leading batch axis. head_logits (B, K, V), token_history
    (B, L), num_decoded (B,) and min_len (B,) integer tensors, gumbel_nuc
    (B, K, KMAX), gumbel_flat (B, K, V). Returns (B, K) int64."""
    k = head_logits.shape[1]
    dev = head_logits.device
    num = num_decoded.to(dev).long()
    ignore = (num[:, None] + torch.arange(k, device=dev)) < min_len.to(dev)[:, None]
    cands, reps, maskeds = _ras_candidate(
        head_logits, token_history[:, None, :], num[:, None, None], params, ignore,
        speech_token_size, gumbel_nuc)
    flats = _gumbel_argmax(torch.log_softmax(maskeds, dim=-1), gumbel_flat)
    return torch.where(reps, flats, cands)
