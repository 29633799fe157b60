"""Frame-rate -> sample-rate linear upsampling and harmonic masking
(mirrors ddsp_svc_tpu/ops/interp.py ``upsample``, ``remove_above_fmax``)."""
from __future__ import annotations

import torch


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
