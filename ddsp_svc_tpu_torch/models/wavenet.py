"""Diffusion-step embedding (mirrors ddsp_svc_tpu/models/wavenet.py
``sinusoidal_pos_emb``)."""
from __future__ import annotations

import math

import torch


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) float steps -> (B, dim) = [sin(t w), cos(t w)],
    w_k = exp(-k log(10000) / (dim/2 - 1))."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device) * -scale)
    emb = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
