"""The DDSP synthesisers (mirrors ddsp_svc_tpu/models/ddsp.py:
``sins_harmonic_bank``, ``Sins``, ``combsub_stft_synthesis``,
``CombSubSuperFast``, ``combsub_fast_synthesis``, ``CombSubFast``,
``CombSub``). Sins' harmonic bank runs through kernel K4
(ops/cuda_oscillator.harmonic_bank), CombSubSuperFast's exciter through
kernel K1 (ops/cuda_source.combtooth). Every random draw can be injected
(``noise=``); what is not injected comes from ``generator``. Each synth's
``controls`` takes a time-sharded block's ``frame_mask``, ``group`` and
``edge_mask`` (models/unit2control.py; the drivers are in ``parallel/``)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.cuda_oscillator import harmonic_bank
from ..ops.cuda_source import combtooth
from ..ops.fir import frequency_filter
from ..ops.interp import remove_above_fmax, upsample
from ..ops.source import blocked_cumsum, cumsum_phase_source
from ..ops.spectral import frame_signal, istft, overlap_add, stft
from ..ops.window import hann_window, sqrt_hann_window
from .nn import weak
from .unit2control import Unit2Control


def _uniform_noise(like: torch.Tensor, generator) -> torch.Tensor:
    """U(-1, 1) of ``like``'s shape, as the JAX models draw it."""
    return torch.rand(like.shape, generator=generator, device=like.device,
                      dtype=like.dtype) * 2.0 - 1.0


def _unit_phasor(angle: torch.Tensor) -> torch.Tensor:
    """exp(1j * angle), complex64 (a bf16 angle is widened exactly, as JAX
    promotes it against the complex unit)."""
    angle = angle.float()
    return torch.polar(torch.ones_like(angle), angle)


def _group_phase(group_delay: torch.Tensor) -> torch.Tensor:
    """cumsum of the group delay over bins: torch's on float32; on bf16 the
    order XLA's CPU backend sums ``jnp.cumsum`` in, each sum rounded to
    bf16 (``blocked_cumsum``), as the JAX model's bf16 cumsum."""
    if group_delay.dtype == torch.float32:
        return torch.cumsum(group_delay, dim=-1)
    return blocked_cumsum(group_delay)


def _complex_filter(magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """exp(magnitude + 1j * pi * phase), complex64. JAX promotes bf16
    controls to complex64 before the exponential, so a bf16 model's
    controls are widened (exactly) first."""
    return torch.polar(torch.exp(magnitude.float()), math.pi * phase.float())


def _phase_source(f0_frames, sampling_rate, block_size, initial_phase):
    """-> (f0 (B, L, 1), wrapped phase x (B, L, 1) in cycles, phase at each
    frame start (B, T, 1) in radians)."""
    f0 = upsample(f0_frames, block_size)
    x = cumsum_phase_source(f0, sampling_rate, block_size, initial_phase)
    return f0, x, 2.0 * math.pi * x[:, ::block_size, :]


def sins_harmonic_bank(phase: torch.Tensor, amplitudes_frames: torch.Tensor,
                       block_size: int, max_upsample_dim: int = 32
                       ) -> torch.Tensor:
    """The JAX model's harmonic bank, in radians and 32-harmonic chunks:
    phase (B, L, 1), amplitudes (B, T, n_harm) -> (B, L). Sins itself
    computes the same function through K4 (``harmonic_bank``), in cycles."""
    n_harmonic = amplitudes_frames.shape[-1]
    level = torch.arange(1, n_harmonic + 1, dtype=phase.dtype,
                         device=phase.device)
    sinusoids = 0.0
    for start in range(0, n_harmonic, max_upsample_dim):
        end = start + max_upsample_dim
        amplitudes = upsample(amplitudes_frames[:, :, start:end], block_size)
        sinusoids = sinusoids + torch.sum(
            torch.sin(phase * level[start:end]) * amplitudes, dim=-1)
    return sinusoids


class Sins(nn.Module):
    """Additive harmonic synthesiser with an LTV all-pass and a filtered
    noise branch."""
    NOISE = "uniform"  # the synth noise draw: U(-1, 1) or N(0, 1)

    def __init__(self, sampling_rate: int, block_size: int, n_harmonics: int,
                 n_mag_allpass: int, n_mag_noise: int, n_unit: int = 256,
                 n_spk: int = 1):
        super().__init__()
        self.sampling_rate, self.block_size = sampling_rate, block_size
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk, {"amplitudes": n_harmonics,
                            "group_delay": n_mag_allpass,
                            "noise_magnitude": n_mag_noise})

    def controls(self, units, f0_frames, phase_frames, volume, spk_id=None,
                 spk_mix_dict=None, frame_mask=None, group=None,
                 edge_mask=None):
        """-> (amplitudes (exp-scaled, fmax-masked), group_delay,
        noise_param, hidden)."""
        ctrls, hidden = self.unit2ctrl(units, f0_frames, phase_frames, volume,
                                       spk_id=spk_id, spk_mix_dict=spk_mix_dict,
                                       frame_mask=frame_mask, group=group,
                                       edge_mask=edge_mask)
        amplitudes = torch.exp(ctrls["amplitudes"]) / 128.0
        group_delay = weak(math.pi, ctrls["group_delay"]) * torch.tanh(ctrls["group_delay"])
        noise_param = torch.exp(ctrls["noise_magnitude"]) / 128.0
        amplitudes = remove_above_fmax(amplitudes, f0_frames,
                                       self.sampling_rate / 2, level_start=1)
        return amplitudes, group_delay, noise_param, hidden

    def forward(self, units, f0_frames, volume, spk_id=None,
                initial_phase=None, noise=None,
                generator: torch.Generator | None = None, spk_mix_dict=None):
        """units (B, T, n_unit), f0/volume (B, T, 1) -> (signal (B, T *
        block), hidden). ``noise`` (B, T * block) is the U(-1, 1) draw;
        ``spk_mix_dict`` {id: weight} replaces ``spk_id``."""
        _, x, phase_frames = _phase_source(f0_frames, self.sampling_rate,
                                           self.block_size, initial_phase)
        amplitudes, group_delay, noise_param, hidden = self.controls(
            units, f0_frames, phase_frames, volume, spk_id=spk_id,
            spk_mix_dict=spk_mix_dict)
        # JAX's bank upsamples bf16 amplitudes in bf16 and multiplies the
        # f32 sines by them widened (ddsp.py:31-45, interp.py:37-38): K4's
        # bf16-amplitude mode on bf16 amplitudes, its f32 mode otherwise
        sinusoids = harmonic_bank(x.contiguous(), amplitudes.contiguous(),
                                  self.block_size)
        harmonic = frequency_filter(
            sinusoids, _unit_phasor(_group_phase(group_delay)),
            hann_window_flag=False)
        if noise is None:
            noise = _uniform_noise(harmonic, generator)
        noise = frequency_filter(noise, noise_param.to(torch.complex64),
                                 hann_window_flag=True)
        return harmonic + noise, hidden


def combsub_stft_synthesis(combtooth_wav, noise, src_filter, noise_filter,
                           win_length: int, block_size: int,
                           pad_mode: str = "reflect") -> torch.Tensor:
    """stft(comb) * H_src + stft(noise) * H_noise -> istft. Filters are
    complex (B, T + 1, win // 2 + 1); signals (B, T * block)."""
    window = torch.from_numpy(hann_window(win_length)).to(combtooth_wav.device)
    comb_stft = stft(combtooth_wav, win_length, block_size, window=window,
                     pad_mode=pad_mode)
    noise_stft = stft(noise, win_length, block_size, window=window,
                      pad_mode=pad_mode)
    signal_stft = (comb_stft * src_filter.transpose(1, 2)
                   + noise_stft * noise_filter.transpose(1, 2))
    return istft(signal_stft, win_length, block_size, window=window)


class CombSubSuperFast(nn.Module):
    NOISE = "normal"  # the synth noise draw: U(-1, 1) or N(0, 1)
    def __init__(self, sampling_rate: int, block_size: int, win_length: int,
                 n_unit: int = 256, n_spk: int = 1, use_pitch_aug: bool = False):
        super().__init__()
        self.sampling_rate, self.block_size = sampling_rate, block_size
        self.win_length = win_length
        n_bins = win_length // 2 + 1
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk,
            {"harmonic_magnitude": n_bins, "harmonic_phase": n_bins,
             "noise_magnitude": n_bins, "noise_phase": n_bins},
            use_pitch_aug=use_pitch_aug, use_naive_v2=True)

    def controls(self, units, f0, phase, volume, spk_id=None, aug_shift=None,
                 spk_mix_dict=None, frame_mask=None, group=None,
                 edge_mask=None):
        """-> (src_filter, noise_filter, hidden); complex filters
        (B, T, win // 2 + 1)."""
        ctrls, hidden = self.unit2ctrl(units, f0, phase, volume,
                                       spk_id=spk_id, aug_shift=aug_shift,
                                       spk_mix_dict=spk_mix_dict,
                                       frame_mask=frame_mask, group=group,
                                       edge_mask=edge_mask)
        src_filter = _complex_filter(ctrls["harmonic_magnitude"],
                                     ctrls["harmonic_phase"])
        noise_filter = _complex_filter(ctrls["noise_magnitude"],
                                       ctrls["noise_phase"]) / 128.0
        return src_filter, noise_filter, hidden

    def forward(self, units, f0, volume, spk_id=None, aug_shift=None,
                noise=None, generator: torch.Generator | None = None,
                spk_mix_dict=None):
        """units (B, T, n_unit), f0/volume (B, T, 1) -> (signal (B, T * block),
        hidden). ``noise`` (B, T * block) is drawn from ``generator`` when
        not given; ``spk_mix_dict`` {id: weight} replaces ``spk_id``."""
        comb, phase_frames = combtooth(f0, self.sampling_rate, self.block_size)
        src_filter, noise_filter, hidden = self.controls(
            units, f0, phase_frames, volume, spk_id=spk_id, aug_shift=aug_shift,
            spk_mix_dict=spk_mix_dict)
        # duplicate the last filter frame for the (T+1)-th stft frame
        src_filter = torch.cat([src_filter, src_filter[:, -1:]], dim=1)
        noise_filter = torch.cat([noise_filter, noise_filter[:, -1:]], dim=1)
        if noise is None:
            noise = torch.randn(comb.shape, generator=generator,
                                device=comb.device, dtype=comb.dtype)
        pad_mode = "reflect" if comb.shape[-1] > self.win_length // 2 else "constant"
        signal = combsub_stft_synthesis(comb, noise, src_filter, noise_filter,
                                        self.win_length, self.block_size,
                                        pad_mode)
        return signal, hidden


def combsub_fast_synthesis(combtooth_wav, noise, src_filter, noise_filter,
                           block: int) -> torch.Tensor:
    """Framed rFFT filtering with sqrt-Hann windows and overlap-add:
    signals (B, T * block), filters (B, T + 1, block + 1)."""
    window = torch.from_numpy(sqrt_hann_window(2 * block)).to(combtooth_wav.device)

    def filtered_frames(sig, filt):
        frames = frame_signal(torch.nn.functional.pad(sig, (block, block)),
                              2 * block, block) * window
        spec = torch.fft.rfft(frames, 2 * block, dim=-1)
        return torch.fft.irfft(spec * filt, 2 * block, dim=-1) * window

    frames = (filtered_frames(combtooth_wav, src_filter)
              + filtered_frames(noise, noise_filter.to(torch.complex64)))
    return overlap_add(frames, block)[:, block:-block]


def _comb_exciter(x, f0, sampling_rate):
    """sinc(sr * x / (f0 + 1e-3)): (B, L, 1) -> (B, L)."""
    return torch.sinc(sampling_rate * x / (f0 + 1e-3))[..., 0]


class CombSubFast(nn.Module):
    """Combtooth subtractive synthesiser, framed rFFT and overlap-add."""
    NOISE = "uniform"  # the synth noise draw: U(-1, 1) or N(0, 1)

    def __init__(self, sampling_rate: int, block_size: int, n_unit: int = 256,
                 n_spk: int = 1, use_pitch_aug: bool = False,
                 pcmer_norm: bool = False):
        super().__init__()
        self.sampling_rate, self.block_size = sampling_rate, block_size
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk, {"harmonic_magnitude": block_size + 1,
                            "harmonic_phase": block_size + 1,
                            "noise_magnitude": block_size + 1},
            use_pitch_aug=use_pitch_aug, pcmer_norm=pcmer_norm)

    def controls(self, units, f0_frames, phase_frames, volume, spk_id=None,
                 aug_shift=None, spk_mix_dict=None, frame_mask=None,
                 group=None, edge_mask=None):
        """-> (src_filter complex, noise_filter real, hidden), (B, T,
        block + 1)."""
        ctrls, hidden = self.unit2ctrl(units, f0_frames, phase_frames, volume,
                                       spk_id=spk_id, aug_shift=aug_shift,
                                       spk_mix_dict=spk_mix_dict,
                                       frame_mask=frame_mask, group=group,
                                       edge_mask=edge_mask)
        src_filter = _complex_filter(ctrls["harmonic_magnitude"],
                                     ctrls["harmonic_phase"])
        noise_filter = torch.exp(ctrls["noise_magnitude"]) / 128.0
        return src_filter, noise_filter, hidden

    def forward(self, units, f0_frames, volume, spk_id=None, aug_shift=None,
                initial_phase=None, noise=None,
                generator: torch.Generator | None = None, spk_mix_dict=None):
        """-> (signal (B, T * block), hidden); ``noise`` the U(-1, 1) draw."""
        f0, x, phase_frames = _phase_source(f0_frames, self.sampling_rate,
                                            self.block_size, initial_phase)
        src_filter, noise_filter, hidden = self.controls(
            units, f0_frames, phase_frames, volume, spk_id=spk_id,
            aug_shift=aug_shift, spk_mix_dict=spk_mix_dict)
        src_filter = torch.cat([src_filter, src_filter[:, -1:]], dim=1)
        noise_filter = torch.cat([noise_filter, noise_filter[:, -1:]], dim=1)
        comb = _comb_exciter(x, f0, self.sampling_rate)
        if noise is None:
            noise = _uniform_noise(comb, generator)
        return combsub_fast_synthesis(comb, noise, src_filter, noise_filter,
                                      self.block_size), hidden


class CombSub(nn.Module):
    """Combtooth subtractive synthesiser with LTV-FIR filters (the old
    version): all-pass, then a per-frame dynamically windowed harmonic
    filter, plus filtered noise."""
    NOISE = "uniform"  # the synth noise draw: U(-1, 1) or N(0, 1)

    def __init__(self, sampling_rate: int, block_size: int, n_mag_allpass: int,
                 n_mag_harmonic: int, n_mag_noise: int, n_unit: int = 256,
                 n_spk: int = 1):
        super().__init__()
        self.sampling_rate, self.block_size = sampling_rate, block_size
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk, {"group_delay": n_mag_allpass,
                            "harmonic_magnitude": n_mag_harmonic,
                            "noise_magnitude": n_mag_noise})

    def controls(self, units, f0_frames, phase_frames, volume, spk_id=None,
                 spk_mix_dict=None, frame_mask=None, group=None,
                 edge_mask=None):
        """-> (group_delay, src_param, noise_param, hidden)."""
        ctrls, hidden = self.unit2ctrl(units, f0_frames, phase_frames, volume,
                                       spk_id=spk_id, spk_mix_dict=spk_mix_dict,
                                       frame_mask=frame_mask, group=group,
                                       edge_mask=edge_mask)
        group_delay = weak(math.pi, ctrls["group_delay"]) * torch.tanh(ctrls["group_delay"])
        src_param = torch.exp(ctrls["harmonic_magnitude"])
        noise_param = torch.exp(ctrls["noise_magnitude"]) / 128.0
        return group_delay, src_param, noise_param, hidden

    def forward(self, units, f0_frames, volume, spk_id=None,
                initial_phase=None, noise=None,
                generator: torch.Generator | None = None, spk_mix_dict=None):
        """-> (signal (B, T * block), hidden); ``noise`` the U(-1, 1) draw."""
        f0, x, phase_frames = _phase_source(f0_frames, self.sampling_rate,
                                            self.block_size, initial_phase)
        group_delay, src_param, noise_param, hidden = self.controls(
            units, f0_frames, phase_frames, volume, spk_id=spk_id,
            spk_mix_dict=spk_mix_dict)
        comb = _comb_exciter(x, f0, self.sampling_rate)
        harmonic = frequency_filter(
            comb, _unit_phasor(_group_phase(group_delay)),
            hann_window_flag=False)
        harmonic = frequency_filter(
            harmonic, src_param.to(torch.complex64), hann_window_flag=True,
            half_width_frames=1.5 * self.sampling_rate / (f0_frames + 1e-3))
        if noise is None:
            noise = _uniform_noise(harmonic, generator)
        noise = frequency_filter(noise, noise_param.to(torch.complex64),
                                 hann_window_flag=True)
        return harmonic + noise, hidden
