"""K1: the combtooth exciter kernel (``csrc/combtooth.cu``), its plain
PyTorch version and its launch counter.

Replaces ddsp_svc_tpu/ops/pallas_source.py ``combtooth_pallas``. Like the
JAX wrapper, this one computes ds0, the exact integer carry prefix and
``phase_frames`` in torch; the kernel writes the samples.
"""
from __future__ import annotations

import math

import torch

from . import kernels
from .source import (_next_frame_delta, carry_from_increments_q, exact_div,
                     fast_source_gen, frame_phase_increments_q)


def combtooth_plain(f0_frames: torch.Tensor, sampling_rate: int,
                    block_size: int, carry_offset_q: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch: ``fast_source_gen``'s
    arithmetic (ops/source.py)."""
    return fast_source_gen(f0_frames, sampling_rate, block_size, carry_offset_q)


def combtooth(f0_frames: torch.Tensor, sampling_rate: int, block_size: int,
              carry_offset_q: torch.Tensor | None = None):
    """f0 (B, T, 1) Hz -> (combtooth (B, T * block), phase_frames (B, T, 1)).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``combtooth.launches``)."""
    if f0_frames.device.type == "cpu":
        return combtooth_plain(f0_frames, sampling_rate, block_size,
                               carry_offset_q)
    kernels.check_cuda_input(f0_frames, "combtooth f0", 3)
    b, t, one = f0_frames.shape
    if one != 1:
        raise ValueError(f"combtooth: f0 must be (B, T, 1), got {tuple(f0_frames.shape)}")
    s0 = exact_div(f0_frames, sampling_rate).contiguous()
    ds0 = _next_frame_delta(s0).contiguous()
    q = frame_phase_increments_q(f0_frames, sampling_rate, block_size)
    carry = carry_from_increments_q(q, carry_offset_q).contiguous()
    out = torch.empty(b, t * block_size, device=f0_frames.device,
                      dtype=torch.float32)
    err = kernels.library().ddsp_combtooth(
        s0.data_ptr(), ds0.data_ptr(), carry.data_ptr(), out.data_ptr(),
        b * t, block_size, kernels.stream_handle(f0_frames.device))
    kernels.check(err, "combtooth")
    combtooth.launches += 1
    rad_first = s0 + carry
    phase_frames = 2.0 * math.pi * (rad_first - torch.round(rad_first))
    return out, phase_frames


combtooth.launches = 0
