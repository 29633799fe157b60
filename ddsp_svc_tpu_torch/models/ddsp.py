"""CombSubSuperFast, the STFT-domain combtooth subtractive synthesiser
(mirrors ddsp_svc_tpu/models/ddsp.py: ``combsub_stft_synthesis``,
``CombSubSuperFast``). The exciter runs through kernel K1
(ops/cuda_source.combtooth)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.cuda_source import combtooth
from ..ops.spectral import istft, stft
from ..ops.window import hann_window
from .unit2control import Unit2Control


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
            use_pitch_aug=use_pitch_aug)

    def controls(self, units, f0, phase, volume, spk_id=None, aug_shift=None):
        """-> (src_filter, noise_filter, hidden); complex filters
        (B, T, win // 2 + 1)."""
        ctrls, hidden = self.unit2ctrl(units, f0, phase, volume,
                                       spk_id=spk_id, aug_shift=aug_shift)
        src_filter = torch.polar(torch.exp(ctrls["harmonic_magnitude"]),
                                 math.pi * ctrls["harmonic_phase"])
        noise_filter = torch.polar(torch.exp(ctrls["noise_magnitude"]),
                                   math.pi * ctrls["noise_phase"]) / 128.0
        return src_filter, noise_filter, hidden

    def forward(self, units, f0, volume, spk_id=None, aug_shift=None,
                noise=None, generator: torch.Generator | None = None):
        """units (B, T, n_unit), f0/volume (B, T, 1) -> (signal (B, T * block),
        hidden). ``noise`` (B, T * block) is drawn from ``generator`` when
        not given."""
        comb, phase_frames = combtooth(f0, self.sampling_rate, self.block_size)
        src_filter, noise_filter, hidden = self.controls(
            units, f0, phase_frames, volume, spk_id=spk_id, aug_shift=aug_shift)
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
