"""Frame-rate -> sample-rate linear upsampling, harmonic masking and the
CREPE track's pools (mirrors ddsp_svc_tpu/ops/interp.py ``upsample``,
``remove_above_fmax``, ``masked_avg_pool_1d``, ``median_pool_1d``)."""
from __future__ import annotations

import torch

from .source import blocked_cumsum


def upsample(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, C) -> (B, T * factor, C): append the last frame, lerp each
    frame towards its successor at weights j / factor (align_corners grid).
    """
    b, t, c = signal.shape
    nxt = torch.cat([signal[:, 1:], signal[:, -1:]], dim=1)
    w = (torch.arange(factor, dtype=signal.dtype, device=signal.device)
         / factor).reshape(1, 1, factor, 1)
    out = signal[:, :, None, :] * (1.0 - w) + nxt[:, :, None, :] * w
    return out.reshape(b, t * factor, c)


def remove_above_fmax(amplitudes: torch.Tensor, pitch: torch.Tensor,
                      fmax: float, level_start: int = 1) -> torch.Tensor:
    """Scale harmonic amplitudes (B, T, n_harm) whose frequency pitch (B, T,
    1) x level reaches fmax by 1e-7 (the others by 1 + 1e-7), as JAX."""
    n_harm = amplitudes.shape[-1]
    levels = torch.arange(level_start, n_harm + level_start,
                          dtype=pitch.dtype, device=pitch.device)
    aa = (pitch * levels < fmax).to(amplitudes.dtype) + 1e-7
    return amplitudes * aa


def _reflect_pad(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    pad_l, pad_r = (kernel_size - 1) // 2, kernel_size // 2
    return torch.nn.functional.pad(x[:, None, :], (pad_l, pad_r),
                                   mode="reflect")[:, 0, :]


def masked_avg_pool_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """NaN-masked average pooling over the last axis of (B, T), stride 1,
    reflect-padded: each window's sum of its non-NaN values over their
    count (at least 1), both read off prefix sums as JAX does (a box
    filter: the difference of two prefix sums, summed in the order of XLA's
    CPU cumsum, ``blocked_cumsum``)."""
    xp = _reflect_pad(x, kernel_size)
    mask = ~torch.isnan(xp)
    vals = torch.where(mask, xp, torch.zeros_like(xp))
    csum = torch.nn.functional.pad(blocked_cumsum(vals), (1, 0))
    cmask = torch.nn.functional.pad(torch.cumsum(mask.to(x.dtype), dim=-1), (1, 0))
    t = x.shape[-1]
    lo = torch.arange(t, device=x.device)
    hi = lo + kernel_size
    win_sum = csum[:, hi] - csum[:, lo]
    win_cnt = torch.clamp(cmask[:, hi] - cmask[:, lo], min=1.0)
    return win_sum / win_cnt


def median_pool_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Median pooling over the last axis of (B, T), stride 1,
    reflect-padded: sorted index (k - 1) // 2 of each window (the lower
    median for an even k)."""
    windows = _reflect_pad(x, kernel_size).unfold(-1, kernel_size, 1)
    return torch.sort(windows, dim=-1).values[..., (kernel_size - 1) // 2]
