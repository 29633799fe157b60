"""The mel cascades (mirrors ddsp_svc_tpu/models/cascade.py), at inference
(``forward``) and in training (``loss``, the JAX ``infer=False`` branch):

- ``Unit2Mel`` (type Diffusion): unit, f0, volume and speaker embeddings ->
  Gaussian diffusion over a WaveNet, from noise (or shallow from a given
  mel, the CLI's -ddsp);
- ``Unit2Wav`` (DiffusionNew): CombSubFast -> its log-mel, refined by
  shallow diffusion over a WaveNet conditioned on the synth's hidden;
- ``Unit2WavFast`` (DiffusionFast): CombSubSuperFast -> log-mel, refined
  by shallow diffusion over a NaiveV2Diff conditioned on that mel;
- ``ReflowUnit2Wav`` (RectifiedFlow): CombSubSuperFast -> log-mel, refined
  by the rectified-flow ODE over a NaiveV2Diff velocity net.

The vocoder's mel extractor is passed in as ``mel_extract_fn``. Every draw
can be injected (``ddsp_noise``, ``init_noise``, ``chain_noise``; in
training the diffusion ``t`` and ``noise``, the reflow ``t`` and ``x_0``);
what is not comes from ``generator``. ``spk_mix_dict`` {id: weight}
replaces ``spk_id``. ``trunk_bf16`` runs the NaiveV2Diff trunks through B3
(JAX ``trunk_pallas=True, trunk_pallas_exact=False``); ``remat`` (JAX
``remat``, ``model.use_remat``) recomputes each denoiser layer in the
backward.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from .ddsp import CombSubFast, CombSubSuperFast
from .diffusion import GaussianDiffusion
from .naive_v2_diff import NaiveV2Diff
from .nn import Dense
from .reflow import RectifiedFlow
from .unit2control import add_speaker
from .wavenet import WaveNet


class Unit2Mel(nn.Module):
    def __init__(self, input_channel: int, n_spk: int,
                 use_pitch_aug: bool = False, out_dims: int = 128,
                 n_layers: int = 20, n_chans: int = 384, n_hidden: int = 256,
                 k_step_max: int = 1000, remat: bool = False):
        super().__init__()
        self.unit_embed = Dense(input_channel, n_hidden)
        self.f0_embed = Dense(1, n_hidden)
        self.volume_embed = Dense(1, n_hidden)
        self.spk_embed = nn.Embedding(n_spk, n_hidden) if n_spk and n_spk > 1 else None
        # dropped by the loader when the checkpoint has none (io/jax_params.py)
        self.aug_shift_embed = (Dense(1, n_hidden, bias=False)
                                if use_pitch_aug else None)
        self.denoise_fn = WaveNet(out_dims, n_layers, n_chans, n_hidden, remat)
        self.decoder = GaussianDiffusion(out_dims, k_step_max)

    def hidden(self, units, f0, volume, spk_id=None, spk_mix_dict=None,
               aug_shift=None) -> torch.Tensor:
        x = (self.unit_embed(units) + self.f0_embed(torch.log1p(f0 / 700.0))
             + self.volume_embed(volume))
        if self.spk_embed is not None:
            x = add_speaker(x, self.spk_embed, spk_id, spk_mix_dict)
        if self.aug_shift_embed is not None and aug_shift is not None:
            x = x + self.aug_shift_embed(aug_shift / 5.0)
        return x

    def loss(self, units, f0, volume, gt_spec, *, spk_id=None, aug_shift=None,
             k_step: int | None = None, t=None, noise=None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The diffusion loss on ``gt_spec`` (B, T, M), t below ``k_step``
        (k_step_max by default)."""
        x = self.hidden(units, f0, volume, spk_id, aug_shift=aug_shift)
        return self.decoder.loss(lambda s, tt: self.denoise_fn(s, tt, x),
                                 gt_spec, k_step, t, noise, generator)

    def forward(self, units, f0, volume, *, spk_id=None, spk_mix_dict=None,
                aug_shift=None, gt_spec=None, infer_speedup: int = 10,
                sampler: str = "dpm-solver", k_step: int | None = 300,
                init_noise=None, chain_noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """units (B, T, n_unit), f0/volume (B, T, 1) -> mel (B, T, M): from
        noise at k_step_max, or shallow from ``gt_spec`` at ``k_step``."""
        x = self.hidden(units, f0, volume, spk_id, spk_mix_dict, aug_shift)
        return self.decoder.infer(
            lambda s, t: self.denoise_fn(s, t, x), gt_spec, k_step,
            infer_speedup, sampler, init_noise=init_noise,
            chain_noise=chain_noise, generator=generator, condition=x)


class Unit2Wav(nn.Module):
    def __init__(self, sampling_rate: int, block_size: int, n_unit: int,
                 n_spk: int, use_pitch_aug: bool = False, out_dims: int = 128,
                 n_layers: int = 20, n_chans: int = 512,
                 pcmer_norm: bool = False, k_step_max: int = 1000,
                 remat: bool = False):
        super().__init__()
        self.ddsp_model = CombSubFast(sampling_rate, block_size, n_unit, n_spk,
                                      use_pitch_aug, pcmer_norm=pcmer_norm)
        self.denoise_fn = WaveNet(out_dims, n_layers, n_chans, 256, remat)
        self.diff_model = GaussianDiffusion(out_dims, k_step_max)

    def loss(self, units, f0, volume, gt_spec, *, mel_extract_fn: Callable,
             spk_id=None, aug_shift=None, k_step: int | None = None,
             ddsp_noise=None, t=None, noise=None,
             generator: torch.Generator | None = None) -> tuple:
        """-> (ddsp_loss, diff_loss): the MSE of the synth's mel against
        ``gt_spec``, and the diffusion loss conditioned on its hidden."""
        ddsp_wav, hidden = self.ddsp_model(units, f0, volume, spk_id=spk_id,
                                           aug_shift=aug_shift, noise=ddsp_noise,
                                           generator=generator)
        ddsp_loss = torch.mean((mel_extract_fn(ddsp_wav) - gt_spec) ** 2)
        diff_loss = self.diff_model.loss(
            lambda s, tt: self.denoise_fn(s, tt, hidden), gt_spec, k_step, t,
            noise, generator)
        return ddsp_loss, diff_loss

    def forward(self, units, f0, volume, *, mel_extract_fn: Callable,
                spk_id=None, spk_mix_dict=None, aug_shift=None,
                infer_speedup: int = 10, sampler: str = "dpm-solver",
                k_step: int | None = None, ddsp_noise=None, init_noise=None,
                chain_noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> mel (B, T, M); no k_step (or 0) returns the DDSP mel."""
        ddsp_wav, hidden = self.ddsp_model(
            units, f0, volume, spk_id=spk_id, aug_shift=aug_shift,
            noise=ddsp_noise, generator=generator, spk_mix_dict=spk_mix_dict)
        ddsp_mel = mel_extract_fn(ddsp_wav)
        if not k_step or k_step <= 0:
            return ddsp_mel
        return self.diff_model.infer(
            lambda s, t: self.denoise_fn(s, t, hidden), ddsp_mel, k_step,
            infer_speedup, sampler, init_noise=init_noise,
            chain_noise=chain_noise, generator=generator)


class Unit2WavFast(nn.Module):
    def __init__(self, sampling_rate: int, block_size: int, win_length: int,
                 n_unit: int, n_spk: int, use_pitch_aug: bool = False,
                 out_dims: int = 128, n_layers: int = 6, n_chans: int = 512,
                 k_step_max: int = 1000, trunk_bf16: bool = False,
                 remat: bool = False):
        super().__init__()
        self.ddsp_model = CombSubSuperFast(sampling_rate, block_size,
                                           win_length, n_unit, n_spk,
                                           use_pitch_aug)
        self.denoise_fn = NaiveV2Diff(mel_channels=out_dims, dim=n_chans,
                                      condition_dim=out_dims,
                                      num_layers=n_layers,
                                      trunk_bf16=trunk_bf16, remat=remat)
        self.diff_model = GaussianDiffusion(out_dims, k_step_max)

    def loss(self, units, f0, volume, gt_spec, *, mel_extract_fn: Callable,
             spk_id=None, aug_shift=None, k_step: int | None = None,
             ddsp_noise=None, t=None, noise=None,
             generator: torch.Generator | None = None) -> tuple:
        """-> (ddsp_loss, diff_loss): the MSE of the synth's mel against
        ``gt_spec``, and the diffusion loss conditioned on that mel (not
        detached, as in JAX)."""
        ddsp_wav, _ = self.ddsp_model(units, f0, volume, spk_id=spk_id,
                                      aug_shift=aug_shift, noise=ddsp_noise,
                                      generator=generator)
        cond = mel_extract_fn(ddsp_wav).contiguous()
        ddsp_loss = torch.mean((cond - gt_spec) ** 2)
        diff_loss = self.diff_model.loss(
            lambda x, tt: self.denoise_fn(x, tt, cond), gt_spec, k_step, t,
            noise, generator)
        return ddsp_loss, diff_loss

    def forward(self, units, f0, volume, *, mel_extract_fn: Callable,
                spk_id=None, spk_mix_dict=None, aug_shift=None,
                infer_speedup: int = 10, sampler: str = "dpm-solver",
                k_step: int | None = None, ddsp_noise=None, init_noise=None,
                chain_noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Inference: units (B, T, n_unit), f0/volume (B, T, 1) -> mel
        (B, T, M); ``mel_extract_fn`` maps the DDSP audio to its mel. No
        k_step (or 0) returns the DDSP mel. ``ddsp_noise`` (B, T * block),
        ``init_noise`` (B, T, M) and the DDPM chain's ``chain_noise``
        (k_step, B, T, M) are drawn from ``generator`` when not given."""
        ddsp_wav, _ = self.ddsp_model(units, f0, volume, spk_id=spk_id,
                                      aug_shift=aug_shift, noise=ddsp_noise,
                                      generator=generator,
                                      spk_mix_dict=spk_mix_dict)
        cond = mel_extract_fn(ddsp_wav).contiguous()
        if not k_step or k_step <= 0:
            return cond
        return self.diff_model.infer(
            lambda x, t: self.denoise_fn(x, t, cond), cond, k_step,
            infer_speedup, sampler, init_noise=init_noise,
            chain_noise=chain_noise, generator=generator)


class ReflowUnit2Wav(nn.Module):
    def __init__(self, sampling_rate: int, block_size: int, win_length: int,
                 n_unit: int, n_spk: int, use_pitch_aug: bool = False,
                 out_dims: int = 128, n_layers: int = 6, n_chans: int = 512,
                 trunk_bf16: bool = False, remat: bool = False):
        super().__init__()
        self.ddsp_model = CombSubSuperFast(sampling_rate, block_size,
                                           win_length, n_unit, n_spk,
                                           use_pitch_aug)
        self.velocity_fn = NaiveV2Diff(mel_channels=out_dims, dim=n_chans,
                                       condition_dim=out_dims,
                                       num_layers=n_layers,
                                       trunk_bf16=trunk_bf16, remat=remat)
        self.reflow_model = RectifiedFlow(out_dims)

    def loss(self, units, f0, volume, gt_spec, *, mel_extract_fn: Callable,
             spk_id=None, aug_shift=None, t_start: float = 0.0,
             ddsp_noise=None, t=None, x_0=None, loss_type: str = "l2_lognorm",
             generator: torch.Generator | None = None) -> tuple:
        """-> (ddsp_loss, reflow_loss): the MSE of the synth's mel against
        ``gt_spec``, and the velocity loss conditioned on that mel."""
        ddsp_wav, _ = self.ddsp_model(units, f0, volume, spk_id=spk_id,
                                      aug_shift=aug_shift, noise=ddsp_noise,
                                      generator=generator)
        cond = mel_extract_fn(ddsp_wav).contiguous()
        ddsp_loss = torch.mean((cond - gt_spec) ** 2)
        reflow_loss = self.reflow_model.loss(
            lambda x, tt: self.velocity_fn(x, tt, cond), gt_spec, t_start, t,
            x_0, loss_type, generator)
        return ddsp_loss, reflow_loss

    def forward(self, units, f0, volume, *, mel_extract_fn: Callable,
                spk_id=None, spk_mix_dict=None, aug_shift=None,
                infer_step: int = 10, sampler: str = "euler",
                t_start: float = 0.0, ddsp_noise=None, init_noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> mel (B, T, M): the ODE over the DDSP mel from ``t_start``, or
        the DDSP mel itself when ``infer_step`` is 0 or ``t_start`` >= 1."""
        ddsp_wav, _ = self.ddsp_model(units, f0, volume, spk_id=spk_id,
                                      aug_shift=aug_shift, noise=ddsp_noise,
                                      generator=generator,
                                      spk_mix_dict=spk_mix_dict)
        cond = mel_extract_fn(ddsp_wav).contiguous()
        if not (infer_step > 0 and t_start < 1.0):
            return cond
        return self.reflow_model.infer(
            lambda x, t: self.velocity_fn(x, t, cond), cond, infer_step,
            sampler, t_start, init_noise=init_noise, generator=generator)
