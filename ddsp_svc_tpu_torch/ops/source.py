"""Excitation sources (mirrors ddsp_svc_tpu/ops/source.py:
``frame_phase_increments_q``, ``carry_from_increments_q``,
``fast_source_gen``, ``cumsum_increments_q``, ``cumsum_phase_source``,
``sine_increments_q``, ``sine_gen``).

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


def exact_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor, correctly rounded on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's rounded
    reciprocal, an ulp off the CPU's (and JAX's) quotient; the phase sources
    quantise sums of such quotients into their integer carries, where an
    ulp moves a whole quantum. A 0-dim tensor divisor takes true division."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


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
    s0 = exact_div(f0_frames, sampling_rate)
    ds0 = _next_frame_delta(s0)
    rad_last = s0 * (n_last + 1.0) + exact_div(
        0.5 * ds0 * n_last * (n_last + 1.0), block_size)
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
    s0 = exact_div(f0_frames, sampling_rate)
    ds0 = _next_frame_delta(s0)
    rad = s0 * (n + 1.0) + exact_div(0.5 * ds0 * n * (n + 1.0), block_size)
    s0_eff = s0 + exact_div(ds0 * n, block_size)
    q = frame_phase_increments_q(f0_frames, sampling_rate, block_size)
    rad = rad + carry_from_increments_q(q, carry_offset_q)
    rad = rad - torch.round(rad)
    combtooth = torch.sinc(rad / (s0_eff + 1e-5))
    combtooth = combtooth.reshape(f0_frames.shape[0], -1)
    phase_frames = 2.0 * math.pi * rad[:, :, :1]
    return combtooth, phase_frames


SCAN_BLOCK = 16


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis in the order XLA's CPU backend
    sums ``jnp.cumsum``: sequentially within blocks of 16, then each block
    offset by the exclusive prefix of the block totals, scanned the same way.
    A float sum depends on its order, and the phase sources quantise each
    frame's sum, so this keeps the port on the JAX package's values bit for
    bit, on the CPU and on the card alike (``torch.cumsum`` sums in yet
    another order)."""
    n = x.shape[-1]
    nb = -(-n // SCAN_BLOCK)
    if nb * SCAN_BLOCK != n:
        x = F.pad(x, (0, nb * SCAN_BLOCK - n))
    blocks = x.reshape(*x.shape[:-1], nb, SCAN_BLOCK)
    cols = [blocks[..., 0]]
    for i in range(1, SCAN_BLOCK):
        cols.append(cols[-1] + blocks[..., i])
    inner = torch.stack(cols, dim=-1)
    if nb > 1:
        totals = blocked_cumsum(inner[..., -1])
        offset = F.pad(totals[..., :-1], (1, 0))
        inner = inner + offset[..., None]
    return inner.reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]


def cumsum_increments_q(f0: torch.Tensor, sampling_rate: int,
                        block_size: int) -> torch.Tensor:
    """(B, L, 1) sample-level f0 -> (B, T, 1) int32 wrapped per-frame sums
    of f0 / sr in units of 2^-22 cycles (L = T * block)."""
    b, l, _ = f0.shape
    inc = exact_div(f0, sampling_rate).reshape(b, l // block_size, block_size)
    return _quantise_frame_sum(blocked_cumsum(inc))


def _quantise_frame_sum(intra: torch.Tensor) -> torch.Tensor:
    """Within-frame phase (B, T, block) -> its wrapped end in 2^-22 cycles."""
    frame_sum = _wrap_half(intra[..., -1:])
    return torch.round(frame_sum * (1 << PHASE_Q_BITS)).to(torch.int32)


def cumsum_phase_source(f0: torch.Tensor, sampling_rate: int, block_size: int,
                        initial_phase: torch.Tensor | None = None,
                        carry_offset_q: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Wrapped phase in cycles, x = frac(cumsum(f0 / sr)), in float32: the
    cumsum runs within each frame and only the int32-quantised frame sums
    are carried across frames. f0 (B, L, 1) -> x (B, L, 1) in [-0.5, 0.5];
    ``initial_phase`` (B, 1, 1) radians."""
    b, l, _ = f0.shape
    t = l // block_size
    inc = exact_div(f0, sampling_rate).reshape(b, t, block_size)
    intra = blocked_cumsum(inc)
    x = intra + carry_from_increments_q(_quantise_frame_sum(intra),
                                        carry_offset_q)
    if initial_phase is not None:
        x = x + exact_div(initial_phase.reshape(b, 1, 1), 2.0 * math.pi)
    x = x - torch.round(x)
    return x.reshape(b, l, 1)


def sine_increments_q(f0: torch.Tensor, upp: int, sampling_rate: int
                      ) -> torch.Tensor:
    """(B, T) f0 -> (B, T, 1) int32 end-of-frame increments of the NSF
    sine source."""
    rad_last = exact_div(f0[..., None], sampling_rate) * upp
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
    rad = exact_div(f0, sampling_rate) * pos
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
