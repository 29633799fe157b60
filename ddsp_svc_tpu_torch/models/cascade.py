"""DiffusionFast cascade (mirrors ddsp_svc_tpu/models/cascade.py
``Unit2WavFast`` at inference): CombSubSuperFast -> log-mel -> shallow
diffusion with a NaiveV2Diff denoiser conditioned on the DDSP mel."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from .ddsp import CombSubSuperFast
from .diffusion import GaussianDiffusion
from .naive_v2_diff import NaiveV2Diff


class Unit2WavFast(nn.Module):
    def __init__(self, sampling_rate: int, block_size: int, win_length: int,
                 n_unit: int, n_spk: int, use_pitch_aug: bool = False,
                 out_dims: int = 128, n_layers: int = 6, n_chans: int = 512):
        super().__init__()
        self.ddsp_model = CombSubSuperFast(sampling_rate, block_size,
                                           win_length, n_unit, n_spk,
                                           use_pitch_aug)
        self.denoise_fn = NaiveV2Diff(mel_channels=out_dims, dim=n_chans,
                                      condition_dim=out_dims,
                                      num_layers=n_layers)
        self.diff_model = GaussianDiffusion()

    def forward(self, units, f0, volume, *, mel_extract_fn: Callable,
                spk_id=None, aug_shift=None, infer_speedup: int = 10,
                sampler: str = "dpm-solver", k_step: int | None = None,
                ddsp_noise=None, init_noise=None, chain_noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Inference: units (B, T, n_unit), f0/volume (B, T, 1) -> mel
        (B, T, M); ``mel_extract_fn`` maps the DDSP audio to its mel. No
        k_step (or 0) returns the DDSP mel. ``ddsp_noise`` (B, T * block),
        ``init_noise`` (B, T, M) and the DDPM chain's ``chain_noise``
        (k_step, B, T, M) are drawn from ``generator`` when not given."""
        ddsp_wav, _ = self.ddsp_model(units, f0, volume, spk_id=spk_id,
                                      aug_shift=aug_shift, noise=ddsp_noise,
                                      generator=generator)
        cond = mel_extract_fn(ddsp_wav).contiguous()
        if not k_step or k_step <= 0:
            return cond
        return self.diff_model.infer(
            lambda x, t: self.denoise_fn(x, t, cond), cond, k_step,
            infer_speedup, sampler, init_noise=init_noise,
            chain_noise=chain_noise, generator=generator)
