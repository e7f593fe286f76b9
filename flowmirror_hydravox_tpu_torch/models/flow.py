"""Flow-matching mel decoder: port of flowmirror_hydravox_tpu/models/flow.py
(CausalMaskedDiffWithDiT + CausalConditionalCFM), whole-utterance and
streaming inference and the CFM training loss.

  - 10 fixed Euler steps over a cosine time schedule, with the classifier-free
    guidance pair batched into one estimator call.
  - The start noise is the reference's fixed buffer (`params["rand_noise"]`,
    see params.make_rand_noise), so the mel is deterministic.
  - `compute_loss` (flow.py:210-262) takes its draws from a noise source
    (noise.py, `flow_loss`): torch cannot replay the JAX key chain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import FlowConfig
from . import dit
from .dit import conv1d, linear


def pre_lookahead(params: dict, cfg: FlowConfig, x, context=None):
    """x: (B, T, C). Right-context conv -> leaky_relu -> left-padded conv(k=3)
    -> residual. The right context is `context` (B, pre_lookahead_len, C),
    the embeddings of the tokens after x, or zeros when None."""
    h = x.transpose(1, 2)
    if context is None:
        h = F.pad(h, (0, cfg.pre_lookahead_len))
    else:
        h = torch.cat([h, context.transpose(1, 2)], dim=2)
    h = F.leaky_relu(conv1d(params["pre_lookahead_conv1"], h), 0.01)
    h = conv1d(params["pre_lookahead_conv2"], F.pad(h, (2, 0)))
    return h.transpose(1, 2) + x


def encode_tokens(params: dict, cfg: FlowConfig, token, token_valid, context_token=None):
    """Token -> mu stream at mel rate: embed, mask, pre-lookahead, repeat by
    token_mel_ratio. token (B, T) int; token_valid (B, T) bool;
    context_token (B, pre_lookahead_len) the lookahead tokens, or None.
    Returns (B, T * token_mel_ratio, input_size)."""
    table = params["input_embedding"]
    emb = table[torch.clamp(token, 0, table.shape[0] - 1).long()]
    emb = emb * token_valid[..., None].to(emb.dtype)
    ctx = None
    if context_token is not None:
        ctx = table[torch.clamp(context_token, 0, table.shape[0] - 1).long()]
    h = pre_lookahead(params, cfg, emb, ctx)
    return torch.repeat_interleave(h, cfg.token_mel_ratio, dim=1)


def project_speaker(params: dict, embedding):
    """L2-normalise then affine 192 -> 80 (flow.py:389-390)."""
    dt = params["spk_embed_affine"]["w"].dtype
    norm = torch.linalg.vector_norm(embedding.to(torch.float32), dim=-1, keepdim=True)
    return linear(params["spk_embed_affine"], (embedding / torch.clamp_min(norm, 1e-12)).to(dt))


def solve_euler(params: dict, cfg: FlowConfig, z, mu, mask, spks, cond, n_timesteps: int,
                streaming: bool = False):
    """Fixed-step Euler with CFG batch-2 per step (flow_matching.py:71-124).
    z (B, 80, T) f32 start noise; returns the mel (B, 80, T) f32."""
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=torch.float32)
    if cfg.t_scheduler == "cosine":
        t_span = 1.0 - torch.cos(t_span * 0.5 * math.pi)
    dts = (t_span[1:] - t_span[:-1]).tolist()
    ts = t_span[:-1].tolist()
    cfg_rate = cfg.inference_cfg_rate

    b = z.shape[0]
    dtype = params["input_embedding"].dtype
    mu2 = torch.cat([mu, torch.zeros_like(mu)]).to(dtype)
    spks2 = torch.cat([spks, torch.zeros_like(spks)]).to(dtype)
    cond2 = torch.cat([cond, torch.zeros_like(cond)]).to(dtype)
    mask2 = torch.cat([mask, mask])

    x = z.to(torch.float32)
    for t, dt in zip(ts, dts):
        x_in = torch.cat([x, x]).to(dtype)
        t_in = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
        v = dit.forward(params["estimator"], cfg.estimator, x_in, mask2, mu2, t_in,
                        spks2, cond2, streaming=streaming).to(torch.float32)
        v_cond, v_uncond = v[:b], v[b:]
        dphi = (1.0 + cfg_rate) * v_cond - cfg_rate * v_uncond
        x = x + dt * dphi
    return x


def inference(params: dict, cfg: FlowConfig, token, token_valid, prompt_feat, prompt_mel_len,
              embedding, n_timesteps: Optional[int] = None, finalize: bool = True,
              streaming: bool = False, emit_valid=None):
    """Full flow inference (flow.py:149-207). token (B, Lp + Lt) prompt +
    generated speech tokens, token_valid (B, Lp + Lt) bool, prompt_feat
    (B or 1, mel_len1, 80) (may be 0-length), prompt_mel_len an int (a shared
    prompt) or (B,) (per-row prompts, flow.py:186-190), embedding (B, 192).
    Returns the mel (B, 80, T_mel) f32, prompt region included.

    finalize=False: the last pre_lookahead_len tokens are conv context only
    and emit no mel. An exact-shape call splits them off here; a
    bucket-padded call passes `emit_valid` (B, T) bool marking the emitting
    tokens instead: the context tokens stay in `token_valid` for the
    lookahead conv, and their frames are masked out of attention (the caller
    cuts them off). `streaming` turns on the DiT's static-chunk mask."""
    n_timesteps = n_timesteps or cfg.n_timesteps
    if finalize or emit_valid is not None:
        h = encode_tokens(params, cfg, token, token_valid)
    else:
        la = cfg.pre_lookahead_len
        h = encode_tokens(params, cfg, token[:, :-la], token_valid[:, :-la],
                          context_token=token[:, -la:])
    b, t_mel, _ = h.shape
    mel_dim = cfg.output_size
    dev = h.device

    spks = project_speaker(params, embedding)

    # the prompt mel fills the first prompt_mel_len frames of the conditioning
    pf = torch.zeros((b, t_mel, mel_dim), dtype=h.dtype, device=dev)
    lp = prompt_feat.shape[1]
    if lp > 0:
        pml = torch.as_tensor(prompt_mel_len, device=dev).reshape(-1, 1)
        in_prompt = torch.arange(t_mel, device=dev)[None, :] < pml
        pf_src = F.pad(prompt_feat.to(h.dtype), (0, 0, 0, max(t_mel - lp, 0)))[:, :t_mel]
        pf = torch.where(in_prompt[:, :, None], pf_src.expand(b, t_mel, mel_dim), pf)
    conds = pf.transpose(1, 2)  # (B, 80, T)

    mask_src = emit_valid if emit_valid is not None else token_valid
    mask = torch.repeat_interleave(mask_src.to(torch.float32), cfg.token_mel_ratio,
                                   dim=1)[:, None, :t_mel]
    z = params["rand_noise"][:, :, :t_mel].expand(b, mel_dim, t_mel).to(torch.float32)
    return solve_euler(params, cfg, z, h.transpose(1, 2), mask, spks, conds, n_timesteps,
                       streaming)


def compute_loss(params: dict, cfg: FlowConfig, noise, token, token_len, feat, feat_len,
                 embedding):
    """CFM training loss (flow.py:312-365 + flow_matching.py:155-194): cosine
    t, OT interpolant, a random mel prefix as the condition of half the rows,
    classifier-free-guidance dropout, masked MSE. token (B, Lt), feat
    (B, T_mel, 80) the target mel with T_mel == Lt * token_mel_ratio,
    embedding (B, 192); `noise.flow_loss` gives the draws. Returns the f32
    scalar loss."""
    b, t_mel, mel_dim = feat.shape
    est = cfg.estimator
    dev = feat.device
    draws = noise.flow_loss(b, t_mel, mel_dim, est.depth, (est.dim, est.dim * est.ff_mult),
                            est.dropout_rate)

    token_valid = torch.arange(token.shape[1], device=dev)[None, :] < token_len[:, None]
    mu = encode_tokens(params, cfg, token, token_valid)[:, :t_mel].transpose(1, 2)
    spks = project_speaker(params, embedding)

    x1 = feat.transpose(1, 2).to(torch.float32)  # (B, 80, T)
    frames = torch.arange(t_mel, device=dev)[None, :]
    mask = (frames < feat_len[:, None]).to(torch.float32)[:, None, :]

    t = draws.t
    if cfg.t_scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * math.pi)
    y = (1.0 - (1.0 - cfg.sigma_min) * t) * draws.z + t * x1
    u = x1 - (1.0 - cfg.sigma_min) * draws.z

    # half the rows carry a random mel prefix as the condition (flow.py:346-353)
    prefix = (draws.idx * 0.3 * feat_len.to(torch.float32)).to(torch.int32)
    cond_sel = (draws.cond >= 0.5)[:, None] & (frames < prefix[:, None])
    cond = torch.where(cond_sel[:, None, :], x1, 0.0)

    if cfg.training_cfg_rate > 0:
        keep = draws.cfg > cfg.training_cfg_rate
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]

    pred = dit.forward(params["estimator"], est, y, mask, mu, t[:, 0, 0], spks, cond,
                       dropout_masks=draws.keep,
                       dropout_rate=est.dropout_rate).to(torch.float32)
    num = torch.sum(((pred - u) * mask) ** 2)
    return num / (torch.clamp_min(torch.sum(mask), 1.0) * mel_dim)
