"""Periodic Hann window, torch convention (mirrors ddsp_svc_tpu/ops/window.py)."""
from __future__ import annotations

import numpy as np


def hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """0.5 * (1 - cos(2*pi*k / N)), N = n (periodic) or n - 1."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / denom))).astype(dtype)
