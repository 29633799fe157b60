"""Window functions, torch convention: periodic by default (mirrors
ddsp_svc_tpu/ops/window.py: ``hann_window``, ``sqrt_hann_window``,
``bartlett_window``)."""
from __future__ import annotations

import numpy as np


def hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """0.5 * (1 - cos(2*pi*k / N)), N = n (periodic) or n - 1."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / denom))).astype(dtype)


def sqrt_hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """sqrt(hann), taken in float64 (CombSubFast's analysis/synthesis window)."""
    return np.sqrt(hann_window(n, periodic, np.float64)).astype(dtype)


def bartlett_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Triangular window: 1 - |2k / N - 1|, N = n (periodic) or n - 1."""
    if n == 1:
        return np.ones(1, dtype=dtype)
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (1.0 - np.abs(2.0 * k / denom - 1.0)).astype(dtype)
