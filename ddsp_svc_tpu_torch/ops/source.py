"""Excitation sources (mirrors ddsp_svc_tpu/ops/source.py:
``frame_phase_increments_q``, ``carry_from_increments_q``,
``fast_source_gen``, ``sine_increments_q``, ``sine_gen``).

Cross-frame phase continuity uses the JAX package's exact integer carry:
each frame's wrapped end-of-frame phase increment is quantised to 2^-22
cycles, and the carry is the exclusive prefix sum of those integers masked
to 22 bits. ``torch.cumsum`` of int32 returns int64; the mask keeps the
residue mod 2^22, so the result is the same as the JAX int32 prefix (whose
natural overflow preserves that residue because 2^22 divides 2^32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PHASE_Q_BITS = 22  # phase carries quantised to 2^-22 cycles


def _wrap_half(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [-0.5, 0.5) with fmod semantics (sign of the dividend)."""
    return torch.fmod(x + 0.5, 1.0) - 0.5


def _next_frame_delta(s0: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) -> s0[t + 1] - s0[t], zero for the last frame."""
    return F.pad(s0[:, 1:, :] - s0[:, :-1, :], (0, 0, 0, 1))


def frame_phase_increments_q(f0_frames: torch.Tensor, sampling_rate: int,
                             block_size: int) -> torch.Tensor:
    """(B, T, 1) f0 in Hz -> (B, T, 1) int32 wrapped end-of-frame phase
    increments in units of 2^-22 cycles."""
    n_last = float(block_size - 1)
    s0 = f0_frames / sampling_rate
    ds0 = _next_frame_delta(s0)
    rad_last = s0 * (n_last + 1.0) + 0.5 * ds0 * n_last * (n_last + 1.0) / block_size
    rad2 = _wrap_half(rad_last)
    return torch.round(rad2 * (1 << PHASE_Q_BITS)).to(torch.int32)


def carry_from_increments_q(q: torch.Tensor,
                            carry_offset_q: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Exclusive prefix of quantised increments -> float carry in cycles
    (mod 1). ``carry_offset_q`` (B, 1, 1): the integer carry of everything
    before this block (streaming), added before dequantisation."""
    acc = torch.cumsum(q, dim=1)  # int64
    carry_q = F.pad(acc[:, :-1, :], (0, 0, 1, 0))
    if carry_offset_q is not None:
        carry_q = carry_q + carry_offset_q.to(carry_q.dtype)
    frac = torch.bitwise_and(carry_q, (1 << PHASE_Q_BITS) - 1)
    return frac.to(torch.float32) / (1 << PHASE_Q_BITS)


def fast_source_gen(f0_frames: torch.Tensor, sampling_rate: int,
                    block_size: int,
                    carry_offset_q: torch.Tensor | None = None):
    """Combtooth exciter with per-frame linear f0 ramps.

    f0_frames (B, T, 1) Hz -> (combtooth (B, T * block), phase_frames
    (B, T, 1) radians at each frame start). The plain arithmetic of kernel
    K1 (``ops/cuda_source.combtooth``)."""
    n = torch.arange(block_size, dtype=f0_frames.dtype, device=f0_frames.device)
    s0 = f0_frames / sampling_rate
    ds0 = _next_frame_delta(s0)
    rad = s0 * (n + 1.0) + 0.5 * ds0 * n * (n + 1.0) / block_size
    s0_eff = s0 + ds0 * n / block_size
    q = frame_phase_increments_q(f0_frames, sampling_rate, block_size)
    rad = rad + carry_from_increments_q(q, carry_offset_q)
    rad = rad - torch.round(rad)
    combtooth = torch.sinc(rad / (s0_eff + 1e-5))
    combtooth = combtooth.reshape(f0_frames.shape[0], -1)
    phase_frames = 2.0 * math.pi * rad[:, :, :1]
    return combtooth, phase_frames


def sine_increments_q(f0: torch.Tensor, upp: int, sampling_rate: int
                      ) -> torch.Tensor:
    """(B, T) f0 -> (B, T, 1) int32 end-of-frame increments of the NSF
    sine source."""
    rad_last = f0[..., None] / sampling_rate * upp
    return torch.round(_wrap_half(rad_last) * (1 << PHASE_Q_BITS)).to(torch.int32)


def sine_gen(f0: torch.Tensor, upp: int, sampling_rate: int, n_harmonics: int,
             sine_amp: float = 0.1, noise_std: float = 0.003,
             voiced_threshold: float = 0.0,
             rand_ini: torch.Tensor | None = None,
             noise: torch.Tensor | None = None,
             carry_offset_q: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """NSF sine-bank excitation: f0 (B, T) -> (B, T * upp, n_harmonics + 1).

    ``rand_ini`` (1, 1, dim) initial phases and ``noise`` (B, T * upp, dim)
    are drawn from ``generator`` when not given."""
    b, t = f0.shape
    dim = n_harmonics + 1
    f0 = f0[..., None]
    pos = torch.arange(1, upp + 1, dtype=f0.dtype, device=f0.device)
    rad = f0 / sampling_rate * pos
    q = sine_increments_q(f0[..., 0], upp, sampling_rate)
    rad = rad + carry_from_increments_q(q, carry_offset_q)
    rad = rad.reshape(b, t * upp, 1)
    rad = rad * torch.arange(1, dim + 1, dtype=f0.dtype,
                             device=f0.device).reshape(1, 1, dim)
    if rand_ini is None:
        rand_ini = torch.rand((1, 1, dim), generator=generator,
                              device=f0.device, dtype=f0.dtype)
        rand_ini[..., 0] = 0.0
    rad = rad + rand_ini
    sines = torch.sin(2.0 * math.pi * rad) * sine_amp
    uv = (f0 > voiced_threshold).to(f0.dtype)
    uv = torch.repeat_interleave(uv, upp, dim=1)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    if noise is None:
        noise = torch.randn(sines.shape, generator=generator,
                            device=f0.device, dtype=f0.dtype)
    return sines * uv + noise_amp * noise
