"""Frame-rate -> sample-rate linear upsampling (mirrors
ddsp_svc_tpu/ops/interp.py ``upsample``)."""
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
