"""NSF-HiFiGAN GAN training (mirrors ddsp_svc_tpu/train/vocoder_solver.py:
``Discriminators``, the discriminator and generator steps, and the states
``init_vocoder_training`` makes): LSGAN losses on MPD + MSD, the feature
loss and 45 x the L1 of the log-mels, AdamW with b1 0.8, b2 0.99 and
optax's default weight decay of 1e-4 on every parameter, no schedule.

The discriminator step runs the generator under ``no_grad`` (JAX's
``stop_gradient``); the generator step leaves the discriminators'
parameters out of its backward. With ResBlock1 the generator's stages run
K2 in both steps, through ``ResblockGroupFunction`` in the generator step
(its backward B1, autograd through the plain chain). Every draw of the
generator's sine source can be injected (``sine_kwargs``: ``rand_ini`` and
``noise``); what is not comes from ``rng``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..io.jax_params import vocoder_train_params, vocoder_train_state_dicts
from ..models.nsf_hifigan import (MultiPeriodDiscriminator,
                                  MultiScaleDiscriminator, discriminator_loss,
                                  feature_loss, generator_loss)
from .state import (TrainState, adam_moments, create_train_state,
                    load_adam_moments)
from .steps import apply_update, data_group, global_draws, shard

ADAM_BETAS = (0.8, 0.99)
WEIGHT_DECAY = 1e-4  # optax.adamw's default


class Discriminators(nn.Module):
    """MPD + MSD: (y, y_hat) -> (real scores, fake scores, real feature
    maps, fake feature maps), the MPD's first. ``periods`` and
    ``msd_scales`` default to the HiFiGAN recipe."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 msd_scales: int = 3):
        super().__init__()
        self.periods, self.msd_scales = tuple(periods), int(msd_scales)
        self.mpd = MultiPeriodDiscriminator(self.periods)
        self.msd = MultiScaleDiscriminator(self.msd_scales)

    def forward(self, y, y_hat):
        pr, pg, pfr, pfg = self.mpd(y, y_hat)
        sr, sg, sfr, sfg = self.msd(y, y_hat)
        return pr + sr, pg + sg, pfr + sfr, pfg + sfg


def create_states(generator: nn.Module, discriminators: Discriminators,
                  lr: float) -> tuple[TrainState, TrainState]:
    """The two optimizers of the recipe (JAX ``init_vocoder_training``)."""
    return tuple(create_train_state(m, lr=lr, weight_decay=WEIGHT_DECAY,
                                    betas=ADAM_BETAS)
                 for m in (generator, discriminators))


def _rand_ini(shape, rng, device) -> torch.Tensor:
    u = torch.rand(shape, generator=rng, device=device)
    u[..., 0] = 0.0  # the fundamental starts at phase 0
    return u


def sine_draws(generator: nn.Module, batch: dict, sine_kwargs=None,
               rng: torch.Generator | None = None) -> dict:
    """The sine source's draws at the global batch's shape, in the order it
    draws them: ``rand_ini`` (1, 1, dim) and ``noise`` (B, T * upp, dim);
    those of ``sine_kwargs`` in their place."""
    dim = generator.m_source.harmonic_num + 1
    b, t = batch["f0"].shape[:2]
    return global_draws({"rand_ini": ((1, 1, dim), _rand_ini),
                         "noise": ((b, t * generator.upp, dim), "normal")},
                        sine_kwargs, rng, batch["f0"].device)


def synth(generator: nn.Module, batch: dict, sine_kwargs=None,
          rng: torch.Generator | None = None) -> torch.Tensor:
    return generator(batch["mel"], batch["f0"][..., 0], sine_kwargs=sine_kwargs,
                     generator=rng)


def disc_step(state_d: TrainState, generator: nn.Module, batch: dict,
              sine_kwargs=None, rng=None, mesh=None) -> dict:
    """One discriminator update on the batch's audio against the
    generator's (held fixed)."""
    draws = sine_draws(generator, batch, sine_kwargs, rng)
    batch, draws, share = shard(mesh, batch, draws, ("noise",))
    with torch.no_grad():
        y_hat = synth(generator, batch, draws)
    reals, fakes, _, _ = state_d.model(batch["audio"], y_hat)
    loss = discriminator_loss(reals, fakes) * share
    (total,) = apply_update(state_d, loss, [loss], data_group(mesh))
    return {"disc_loss": total}


def gen_step(state_g: TrainState, discriminators: nn.Module, batch: dict,
             mel_fn: Callable, sine_kwargs=None, rng=None,
             lambda_mel: float = 45.0, lambda_fm: float = 1.0,
             mesh=None) -> dict:
    """One generator update: adversarial + lambda_fm x feature +
    lambda_mel x mel L1 (the discriminators held fixed)."""
    draws = sine_draws(state_g.model, batch, sine_kwargs, rng)
    batch, draws, share = shard(mesh, batch, draws, ("noise",))
    y_hat = synth(state_g.model, batch, draws)
    discriminators.requires_grad_(False)
    try:
        _, fakes, fmap_r, fmap_g = discriminators(batch["audio"], y_hat)
        adv = generator_loss(fakes) * share
        fm = feature_loss(fmap_r, fmap_g) * share
        mel_l1 = torch.mean(torch.abs(mel_fn(y_hat) - mel_fn(batch["audio"]))) * share
        loss = adv + lambda_fm * fm + lambda_mel * mel_l1
        loss, adv, fm, mel_l1 = apply_update(state_g, loss, [loss, adv, fm, mel_l1],
                                             data_group(mesh))
    finally:
        discriminators.requires_grad_(True)
    return {"gen_loss": loss, "adv": adv, "fm": fm, "mel_l1": mel_l1}


def _host(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def vocoder_payload(state_g: TrainState, state_d: TrainState, cfg: dict,
                    step: int) -> dict:
    """The JAX ``train_vocoder`` checkpoint payload: params and optax
    ``adamw`` states (``{'0': {count, mu, nu}, '1': {}, '2': {}}``) of the
    generator and the discriminators, in the JAX layout."""
    discs = state_d.model
    args = (cfg, discs.periods, discs.msd_scales)
    params = vocoder_train_params(_host(state_g.model.state_dict()),
                                  _host(discs.state_dict()), *args)
    (cg, mg, vg), (cd, md, vd) = adam_moments(state_g), adam_moments(state_d)
    mu = vocoder_train_params(_host(mg), _host(md), *args)
    nu = vocoder_train_params(_host(vg), _host(vd), *args)
    opt = {k: {"0": {"count": np.asarray(c, np.int32), "mu": mu[k], "nu": nu[k]},
               "1": {}, "2": {}}
           for k, c in (("generator", cg), ("discriminator", cd))}
    return {"global_step": int(step), "params": params, "opt_state": opt}


def restore_payload(state_g: TrainState, state_d: TrainState, cfg: dict,
                    payload: dict) -> None:
    """Load a JAX ``train_vocoder`` checkpoint's params and, where it has
    them, both optimizer states."""
    from ..io.jax_params import load_state

    discs = state_d.model
    args = (cfg, discs.periods, discs.msd_scales)
    gen, disc = vocoder_train_state_dicts(payload["params"], *args)
    load_state(state_g.model, gen)
    load_state(discs, disc)
    opt = payload.get("opt_state")
    if opt is None:
        return
    mus = vocoder_train_state_dicts(
        {k: opt[k]["0"]["mu"] for k in ("generator", "discriminator")}, *args)
    nus = vocoder_train_state_dicts(
        {k: opt[k]["0"]["nu"] for k in ("generator", "discriminator")}, *args)
    for state, k, mu, nu in ((state_g, "generator", mus[0], nus[0]),
                             (state_d, "discriminator", mus[1], nus[1])):
        load_adam_moments(state, int(np.asarray(opt[k]["0"]["count"])), mu, nu)
