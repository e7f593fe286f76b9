"""LLM extras, the DPO half: port of flowmirror_hydravox_tpu/models/llm_extras.py
(:32-114).

  - `dpo_loss` (reference utils/losses.py:24-64 DPOLoss): the sigmoid
    objective with label smoothing, or IPO;
  - `forward_dpo` (reference llm_multi_head_v3.py:386-435): chosen and
    rejected sequences in one batched forward; head 0's per-sequence mean
    log-probabilities feed the objective, and its CE on the chosen half is
    the SFT term.

The forward takes the heads' training form (`mtp_logits(...,
decode_step=False)`, whose MLP is `qwen2._mlp_block`) for the policy and the
reference model alike, as JAX computes `_mlp_block` in both: the decode form
would send a (2B x T)-row MLP through the GEMV kernel, which has no backward.
So DPO reaches no kernel.

The bistream half (interleaved text/speech sequences and their streaming
inference, JAX :117-288) belongs to the legacy stacks and is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import LLMConfig
from . import qwen2
from .llm import IGNORE_ID, build_lm_input, build_lm_targets, mtp_logits


def dpo_loss(policy_chosen_logps, policy_rejected_logps, reference_chosen_logps,
             reference_rejected_logps, beta: float = 0.1, label_smoothing: float = 0.0,
             ipo: bool = False):
    """DPOLoss.forward. Returns (mean loss, chosen rewards (B,), rejected
    rewards (B,))."""
    logits = ((policy_chosen_logps - policy_rejected_logps)
              - (reference_chosen_logps - reference_rejected_logps))
    if ipo:
        losses = (logits - 1.0 / (2.0 * beta)) ** 2
    else:
        losses = (-F.logsigmoid(beta * logits) * (1.0 - label_smoothing)
                  - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen_rewards = beta * (policy_chosen_logps - reference_chosen_logps)
    rejected_rewards = beta * (policy_rejected_logps - reference_rejected_logps)
    return losses.mean(), chosen_rewards, rejected_rewards


def forward_dpo(params: dict, cfg: LLMConfig, text_token, text_len, chosen_token, chosen_len,
                rejected_token, rejected_len) -> dict:
    """One (2B)-row forward of [chosen; rejected] behind the same texts, each
    speech side right-padded to the longer of the two. Returns {'loss',
    'acc'} (head 0's CE and accuracy on the chosen rows) and
    {'chosen_logps', 'rejected_logps'} (B,), each row's mean log-probability
    of its valid targets."""
    b = text_token.shape[0]
    ls = max(chosen_token.shape[1], rejected_token.shape[1])
    speech = torch.cat([F.pad(chosen_token, (0, ls - chosen_token.shape[1])),
                        F.pad(rejected_token, (0, ls - rejected_token.shape[1]))])
    slen = torch.cat([chosen_len, rejected_len])
    text2 = torch.cat([text_token, text_token])
    tlen2 = torch.cat([text_len, text_len])

    lm_input, lm_len = build_lm_input(params, cfg, text2, tlen2, speech, slen)
    hidden = qwen2.forward(params["backbone"], cfg.backbone, lm_input, lm_len)
    logits = mtp_logits(params, cfg, hidden, 1, decode_step=False)[0]  # head 0: (2B, T, V)
    targets = build_lm_targets(cfg, tlen2, speech, slen, lm_input.shape[1])[0]  # (2B, T)

    valid = targets != IGNORE_ID
    tgt = torch.clamp(targets, min=0)
    logp_all = torch.log_softmax(logits, dim=-1)
    tok_logp = torch.gather(logp_all, -1, tgt[..., None])[..., 0]
    seq_logp = torch.where(valid, tok_logp, 0.0).sum(dim=-1) / torch.clamp(
        valid.sum(dim=-1), min=1)

    cvalid, ctgt = valid[:b], tgt[:b]
    count = torch.clamp(cvalid.sum(), min=1)
    loss = torch.where(cvalid, -tok_logp[:b], 0.0).sum() / count
    acc = (cvalid & (torch.argmax(logits[:b], dim=-1) == ctgt)).sum() / count
    return {"loss": loss, "acc": acc.to(torch.float32), "chosen_logps": seq_logp[:b],
            "rejected_logps": seq_logp[b:]}
