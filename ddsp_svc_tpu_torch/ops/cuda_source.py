"""K1: the combtooth exciter kernel (``csrc/combtooth.cu``), its plain
PyTorch version and its launch counter.

Replaces ddsp_svc_tpu/ops/pallas_source.py ``combtooth_pallas``, the whole
function: the kernel takes f0 and writes the samples and ``phase_frames``,
deriving s0, ds0, the quantised frame increments and their integer carry
prefix itself. A call is two device operations (a memset of the scan's
scratch and the kernel) and no host-to-device copy.

The kernel has no backward, as ``combtooth_pallas`` has no VJP: f0 is
data. The wrapper refuses an f0 that requires grad while grad is on, on
either device, rather than return a tensor cut from the graph.

Traced (``kernels.traced``), the wrapper calls the registered operator
``torch.ops.ddsp_svc.combtooth`` (``kernels.OPS``): its CPU implementation
is the plain version, its CUDA implementation the launch, and its fake
implementation gives the output shapes, so ``torch.export`` keeps the call
as one node that launches the kernel wherever the exported program runs
on the card.
"""
from __future__ import annotations

import torch

from . import kernels
from .source import fast_source_gen


def combtooth_plain(f0_frames: torch.Tensor, sampling_rate: int,
                    block_size: int, carry_offset_q: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch: ``fast_source_gen``'s
    arithmetic (ops/source.py)."""
    return fast_source_gen(f0_frames, sampling_rate, block_size, carry_offset_q)


def combtooth(f0_frames: torch.Tensor, sampling_rate: int, block_size: int,
              carry_offset_q: torch.Tensor | None = None):
    """f0 (B, T, 1) Hz -> (combtooth (B, T * block), phase_frames (B, T, 1)).
    ``carry_offset_q`` (B, 1, 1) int32 or int64: the integer carry of
    everything before this block (streaming), on f0's device.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``combtooth.launches``); traced, the operator
    stands for either. An f0 that requires grad, with grad on, raises: the
    exciter has no backward."""
    if kernels.grad_wanted(f0_frames):
        raise RuntimeError("combtooth: f0 requires grad, but the combtooth "
                           "exciter has no backward (f0 is data, as in the "
                           "JAX package); pass f0.detach()")
    if kernels.traced():
        return _COMBTOOTH(f0_frames, carry_offset_q, float(sampling_rate),
                          int(block_size))
    if f0_frames.device.type == "cpu":
        return combtooth_plain(f0_frames, sampling_rate, block_size,
                               carry_offset_q)
    return _launch(f0_frames, carry_offset_q, sampling_rate, block_size)


def _combtooth_fake(f0_frames, carry_offset_q, sampling_rate, block_size):
    b, t, _ = f0_frames.shape
    return (f0_frames.new_empty(b, t * block_size),
            f0_frames.new_empty(b, t, 1))


def _launch(f0_frames, carry_offset_q, sampling_rate, block_size):
    kernels.check_cuda_input(f0_frames, "combtooth f0", 3)
    b, t, one = f0_frames.shape
    if one != 1:
        raise ValueError(f"combtooth: f0 must be (B, T, 1), got {tuple(f0_frames.shape)}")
    offset_ptr, offset_is_64 = None, 0
    if carry_offset_q is not None:
        if (carry_offset_q.device != f0_frames.device
                or carry_offset_q.dtype not in (torch.int32, torch.int64)
                or carry_offset_q.numel() != b
                or not carry_offset_q.is_contiguous()):
            raise ValueError("combtooth: carry_offset_q must be a contiguous "
                             f"int32 or int64 ({b}, 1, 1) tensor on "
                             f"{f0_frames.device}")
        offset_ptr = carry_offset_q.data_ptr()
        offset_is_64 = int(carry_offset_q.dtype == torch.int64)
    dev = f0_frames.device
    lib = kernels.library()
    out = torch.empty(b, t * block_size, device=dev, dtype=torch.float32)
    phase_frames = torch.empty(b, t, 1, device=dev, dtype=torch.float32)
    scratch = torch.empty(lib.ddsp_combtooth_scratch_words(b, t), device=dev,
                          dtype=torch.int32)
    kernels.launch(
        "combtooth", "ddsp_combtooth", dev, f0_frames.data_ptr(), offset_ptr,
        offset_is_64, out.data_ptr(), phase_frames.data_ptr(),
        scratch.data_ptr(), b, t, block_size, float(sampling_rate))
    kernels.count_launch(combtooth)
    return out, phase_frames


combtooth.launches = 0
_COMBTOOTH = kernels.register_op(
    "combtooth(Tensor f0_frames, Tensor? carry_offset_q, float sampling_rate, "
    "int block_size) -> (Tensor, Tensor)",
    lambda f0, offset, sr, block: combtooth_plain(f0, sr, block, offset),
    _launch, _combtooth_fake)
