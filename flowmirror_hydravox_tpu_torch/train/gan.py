"""Vocoder GAN training: losses and the two-optimizer train step, on one
device. Port of flowmirror_hydravox_tpu/train/gan.py.

  gen loss  = adv (LSGAN) + 2 x feature matching + 45 x multi-resolution mel
              L1 + 1 x TPR + L1 of the predicted F0 against `pitch_feat`
  disc loss = LSGAN real/fake + TPR

The generator is the HiFT (models/hift.py), the discriminators
models/discriminator.py; each model has its own `Optimizer`. A step updates
the generator first, against the discriminators' parameters as they were,
then the discriminators on the detached fake (the reference's GAN executor
order). The JAX package runs the two halves as one program or as two
(`--split_step`), which give the same update; here they always run one
after the other.

  - The generator's gradients are taken with respect to its own leaves only
    (`torch.autograd.grad`): the discriminators enter its loss as constants,
    and their real-audio pass runs without a graph.
  - The vocoder's two draws (NSF `rand_ini` and noise) come from a noise
    source (`noise.vocoder(b, t, nh)`), split per micro-batch under
    accumulation (`noise.split(k)`), as the JAX step splits its key.
  - Accumulation is the trainers' (`steps._value_and_grad_accum`, the JAX
    `_scan_accum`'s twin): micro-batches of B // k rows in order, gradients
    and metrics summed in f32 and averaged. The micro-batch fakes are put
    back together row by row to (B, T), so the discriminator half splits them
    as it splits the real audio; TPR's median is taken per micro-batch.
  - The JAX package rematerialises the discriminators inside the generator's
    loss (`jax.checkpoint`) to bound its compile's memory. That changes no
    value, and the port keeps the activations.

The update is in place, as the other train steps' (train/steps.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import HiFTConfig
from ..models import discriminator as disc_model
from ..models import hift as hift_model
from ..utils.audio import mel_spectrogram
from .steps import Optimizer, TrainState, _apply, _value_and_grad_accum

MEL_TRANSFORMS = (  # (n_fft, num_mels, hop, win) multi-resolution mel set
    (1024, 80, 256, 1024),
    (2048, 80, 512, 2048),
    (512, 80, 128, 512),
)
MEL_WEIGHT = 45.0  # the loss weights and TPR threshold of the JAX trainer
TPR_WEIGHT = 1.0
TPR_TAU = 0.04


def discriminator_loss(real_scores, fake_scores):
    """LSGAN: mean((1 - Dr)^2) + mean(Dg^2) summed over sub-discriminators."""
    loss = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        loss = loss + (torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2))
    return loss


def generator_adv_loss(fake_scores):
    return sum(torch.mean((1.0 - dg) ** 2) for dg in fake_scores)


def feature_loss(real_fmaps, fake_fmaps):
    """L1 feature matching, times 2."""
    loss = 0.0
    for fr, ff in zip(real_fmaps, fake_fmaps):
        for r, f in zip(fr, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss * 2.0


def median(x):
    """numpy's median of all elements (`jnp.median`): the mean of the two
    middle values of an even count, (lo + hi) * 0.5, so each gets half the
    gradient. `torch.median` returns the lower one."""
    s = torch.sort(x.flatten()).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def tpr_loss(real_scores, fake_scores, tau: float = 0.04):
    """Relativistic truncated pointwise loss (reference utils/losses.py:6-13)."""
    loss = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        diff = dr - dg
        m = median(diff)
        mask = dr < dg + m
        sq = ((diff - m) ** 2) * mask
        l_rel = torch.sum(sq) / torch.clamp_min(torch.sum(mask), 1)
        loss = loss + (tau - torch.relu(tau - l_rel))
    return loss


def multi_mel_loss(real, fake, sample_rate: int):
    """Multi-resolution mel L1 (reference utils/losses.py:15-21)."""
    loss = 0.0
    for n_fft, nm, hop, win in MEL_TRANSFORMS:
        mr = mel_spectrogram(real, n_fft, nm, sample_rate, hop, win)
        mf = mel_spectrogram(fake, n_fft, nm, sample_rate, hop, win)
        loss = loss + torch.mean(torch.abs(mr - mf))
    return loss


def detached(tree):
    """The same structure of tensors, each detached from autograd."""
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [detached(v) for v in tree]
    return tree.detach()


def gen_loss_fn(disc_params: dict, cfg: HiFTConfig, *, fakes=None):
    """The generator's loss `fn(gen_params, batch, noise) -> (total, parts)`
    against the fixed `disc_params`; batch: speech_feat (B, T_mel, 80),
    speech (B, T) and optionally pitch_feat (B, T_mel). Each call appends its
    detached fake to the list `fakes` when one is given."""
    disc = detached(disc_params)

    def fn(gp, mb, noise):
        mel = mb["speech_feat"].transpose(1, 2)
        real = mb["speech"]
        fake, f0 = hift_model.vocode(gp, cfg, mel, noise)
        if fakes is not None:
            fakes.append(fake.detach())
        with torch.no_grad():
            real_scores, real_fmaps = disc_model.forward(disc, real)
        fake_scores, fake_fmaps = disc_model.forward(disc, fake)
        adv = generator_adv_loss(fake_scores)
        fm = feature_loss(real_fmaps, fake_fmaps)
        mel_l = multi_mel_loss(real, fake, cfg.sampling_rate) * MEL_WEIGHT
        tpr = tpr_loss(real_scores, fake_scores, TPR_TAU) * TPR_WEIGHT
        pitch = mb.get("pitch_feat")
        # a tensor, not a Python 0.0: accumulation sums every part in f32
        f0_l = (torch.mean(torch.abs(f0 - pitch)) if pitch is not None
                else torch.zeros((), dtype=torch.float32, device=f0.device))
        total = adv + fm + mel_l + tpr + f0_l
        return total, dict(adv=adv, fm=fm, mel=mel_l, tpr=tpr, f0=f0_l)

    return fn


def disc_loss_fn(dp, mb):
    """The discriminators' loss on {"real", "fake"} -> (loss, None)."""
    real_scores, _ = disc_model.forward(dp, mb["real"])
    fake_scores, _ = disc_model.forward(dp, mb["fake"])
    d = discriminator_loss(real_scores, fake_scores)
    return d + tpr_loss(real_scores, fake_scores, TPR_TAU) * TPR_WEIGHT, None


def gan_gen_step(gen_state: TrainState, disc_params: dict, batch: dict, noise,
                 cfg: HiFTConfig, optimizer: Optimizer, *,
                 accum_steps: int = 1) -> Tuple[TrainState, torch.Tensor, dict]:
    """The generator half: one update of `gen_state` against `disc_params`.
    Returns (gen_state, the detached fake (B, T), {"gen_loss",
    "gen_grad_norm", "adv", "fm", "mel", "tpr", "f0"})."""
    fakes = []
    loss_fn = gen_loss_fn(disc_params, cfg, fakes=fakes)
    loss, parts, grads = _value_and_grad_accum(loss_fn, gen_state.params, batch, accum_steps,
                                               noise)
    gnorm = _apply(gen_state, grads, optimizer)
    return gen_state, torch.cat(fakes), {"gen_loss": loss, "gen_grad_norm": gnorm, **parts}


def gan_disc_step(disc_state: TrainState, real, fake, optimizer: Optimizer, *,
                  accum_steps: int = 1) -> Tuple[TrainState, dict]:
    """The discriminator half: one update of `disc_state` on real (B, T) and
    the detached fake (B, T). accum_steps must be the generator half's, so
    that the micro-batches of real and fake line up. Returns (disc_state,
    {"disc_loss", "disc_grad_norm"})."""
    loss, _, grads = _value_and_grad_accum(disc_loss_fn, disc_state.params,
                                           {"real": real, "fake": fake}, accum_steps)
    gnorm = _apply(disc_state, grads, optimizer)
    return disc_state, {"disc_loss": loss, "disc_grad_norm": gnorm}


def gan_train_step(gen_state: TrainState, disc_state: TrainState, batch: dict, noise,
                   cfg: HiFTConfig, gen_opt: Optimizer, disc_opt: Optimizer, *,
                   accum_steps: int = 1) -> Tuple[TrainState, TrainState, dict]:
    """One generator update, then one discriminator update on its detached
    fake. batch: speech_feat (B, T_mel, 80), speech (B, T), optionally
    pitch_feat (B, T_mel), tensors on the parameters' device. Returns
    (gen_state, disc_state, both halves' metrics)."""
    gen_state, fake, gm = gan_gen_step(gen_state, disc_state.params, batch, noise, cfg, gen_opt,
                                       accum_steps=accum_steps)
    disc_state, dm = gan_disc_step(disc_state, batch["speech"], fake, disc_opt,
                                   accum_steps=accum_steps)
    return gen_state, disc_state, {**gm, **dm}
