"""Train steps for every model family (mirrors ddsp_svc_tpu/train/steps.py):
one step is the forward, the loss, the backward and one AdamW update on one
card, and returns the loss terms as the JAX steps return them.

  - DDSP synths: the RSS multi-scale spectral loss on the waveform;
  - diffusion cascades: lambda_ddsp x MSE(ddsp mel, gt mel) + the diffusion
    loss;
  - Unit2Mel: the diffusion loss alone;
  - the reflow cascade: lambda_ddsp x MSE + the log-normal weighted flow
    loss.

Every draw of a step can be injected through ``draws`` (the synth's noise
``ddsp_noise`` / ``noise``, the diffusion ``t`` and ``noise``, the reflow
``t`` and ``x_0``, the RSS ``rss_idx``); what is not comes from
``generator``. Kernels K1, K3 (or B3) and K4 launch once per forward
through their ``autograd.Function``s, whose backward is the plain chain.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.losses import RSSLoss
from .state import TrainState


def to_device(batch: dict, device) -> dict:
    """A numpy batch -> tensors on ``device`` (spk_id as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def _draw(draws: dict | None, name: str):
    return None if draws is None else draws.get(name)


def _update(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.apply_gradients()


def make_ddsp_train_step(loss_fft_min: int = 256, loss_fft_max: int = 2048,
                         n_scale: int = 4) -> Callable:
    """Train step for Sins / CombSub* models."""
    rss = RSSLoss(loss_fft_min, loss_fft_max, n_scale)

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        signal, _ = state.model(batch["units"], batch["f0"], batch["volume"],
                                spk_id=batch.get("spk_id"),
                                noise=_draw(draws, "noise"), generator=generator)
        loss = rss(signal, batch["audio"], _draw(draws, "rss_idx"), generator)
        _update(state, loss)
        return {"loss": loss.detach()}

    step.rss = rss
    return step


def make_cascade_train_step(mel_extract_fn: Callable, lambda_ddsp: float = 1.0,
                            k_step_max: int | None = None,
                            family: str = "diffusion",
                            t_start: float = 0.0) -> Callable:
    """Train step for Unit2Wav / Unit2WavFast ('diffusion') and
    ReflowUnit2Wav ('reflow'); the batch may carry ``aug_shift``."""

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        kwargs = dict(mel_extract_fn=mel_extract_fn, spk_id=batch.get("spk_id"),
                      aug_shift=batch.get("aug_shift"),
                      ddsp_noise=_draw(draws, "ddsp_noise"),
                      t=_draw(draws, "t"), generator=generator)
        if family == "diffusion":
            kwargs.update(k_step=k_step_max, noise=_draw(draws, "noise"))
        else:
            kwargs.update(t_start=t_start, x_0=_draw(draws, "x_0"))
        ddsp_loss, diff_loss = state.model.loss(
            batch["units"], batch["f0"], batch["volume"], batch["mel"], **kwargs)
        loss = lambda_ddsp * ddsp_loss + diff_loss
        _update(state, loss)
        return {"loss": loss.detach(), "ddsp_loss": ddsp_loss.detach(),
                "diff_loss": diff_loss.detach()}

    return step


def make_unit2mel_train_step(k_step_max: int | None = None) -> Callable:
    """Train step for the pure-diffusion Unit2Mel."""

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        loss = state.model.loss(batch["units"], batch["f0"], batch["volume"],
                                batch["mel"], spk_id=batch.get("spk_id"),
                                aug_shift=batch.get("aug_shift"),
                                k_step=k_step_max, t=_draw(draws, "t"),
                                noise=_draw(draws, "noise"), generator=generator)
        _update(state, loss)
        return {"loss": loss.detach()}

    return step
