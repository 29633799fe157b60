"""Windowed-sinc polyphase resampling with torchaudio's ``sinc_interp_hann``
kernel (mirrors ddsp_svc_tpu/ops/resample.py ``resample``): the same
kernel, built on the host in float64, applied as one strided ``F.conv1d``
with one output channel per filter phase."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 128,
                         rolloff: float = 0.99):
    """-> (kernels (new, 1, 2 width + orig) float32, width, orig, new), the
    rates divided by their gcd."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // gcd, int(new_freq) // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernels *= window * base_freq / orig
    return kernels.astype(np.float32)[:, None, :], width, orig, new


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 128, rolloff: float = 0.99
             ) -> torch.Tensor:
    """(B, L) at orig_freq -> (B, ceil(new * L / orig)) at new_freq."""
    if orig_freq == new_freq:
        return waveform
    kernels, width, orig, new = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    b, length = waveform.shape
    kernel = torch.from_numpy(kernels).to(device=waveform.device,
                                          dtype=waveform.dtype)
    x = F.pad(waveform[:, None, :], (width, width + orig))
    y = F.conv1d(x, kernel, stride=orig)  # (B, new, length // orig + 1)
    y = y.transpose(1, 2).reshape(b, -1)
    return y[:, :int(math.ceil(new * length / orig))]
