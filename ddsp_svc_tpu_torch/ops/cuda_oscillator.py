"""K4: the Sins harmonic bank as a CUDA kernel (``csrc/oscillator.cu``),
its plain PyTorch version and its launch counter.

Replaces ddsp_svc_tpu/ops/pallas_oscillator.py ``harmonic_bank_pallas``:
the same function of the wrapped phase in cycles, so the kernel is held to
the Pallas formula, ``sin((2 pi (k + 1)) x)``; the radians form of
``models/ddsp.sins_harmonic_bank`` stays the JAX model's reference. The
kernel follows each sample's harmonics by a three-term recurrence,
restarted every 16 harmonics from an exact sincos of this plain version's
rounded argument (tests/test_torch_osc_precision.py emulates its order).

bf16 amplitudes take the kernel's bf16-amplitude mode, JAX's bf16 Sins:
the amplitudes upsampled in bf16 (``w = bf16(bf16(j) / bf16(block))``, the
block rounded too as JAX types the Python int weakly, ``1 - w``, both
products and their sum each rounded to bf16), then widened and multiplied
by the f32 sines; the plain version rounds the same way.

With grad on, ``HarmonicBankFunction`` gives the kernel a backward of its
own: autograd through ``harmonic_bank_plain`` recomputed from the saved
phase and amplitudes. It is the port's: the JAX Sins model differentiates
its stock bank (ddsp_svc_tpu/models/ddsp.py:134) and never the Pallas one.

Traced (``kernels.traced``), the wrapper calls the registered operator
``torch.ops.ddsp_svc.harmonic_bank`` (``kernels.OPS``), in both modes: the
plain version on the CPU, the launch on the card, shapes while tracing.
"""
from __future__ import annotations

import math

import torch

from . import kernels
from .source import exact_div

CHUNK = 32  # harmonics per step of the plain version (bounds its temporaries)


def bf16_upsample_weights(block_size: int, device=None):
    """(w, 1 - w) of JAX's bf16 upsample, (1, 1, block, 1) bf16: w =
    bf16(bf16(j) / bf16(block)), each op in f32 rounded to bf16."""
    j = torch.arange(block_size, dtype=torch.float32, device=device)
    factor = torch.tensor(float(block_size)).to(torch.bfloat16).item()
    w = (j.to(torch.bfloat16).float() / factor).to(torch.bfloat16)
    return w.reshape(1, 1, block_size, 1), (1.0 - w).reshape(1, 1, block_size, 1)


def harmonic_bank_plain(x: torch.Tensor, amplitudes_frames: torch.Tensor,
                        block_size: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, L, 1) cycles,
    amplitudes (B, T, n_harm) with L = T * block -> (B, L). bf16
    amplitudes are upsampled in bf16 (the bf16-amplitude mode)."""
    b, t, n_harm = amplitudes_frames.shape
    xr = x.reshape(b, t, block_size, 1)
    bf16 = amplitudes_frames.dtype == torch.bfloat16
    if bf16:
        w, omw = bf16_upsample_weights(block_size, x.device)
    else:
        w = exact_div(torch.arange(block_size, dtype=x.dtype, device=x.device),
                      block_size).reshape(1, 1, block_size, 1)
        omw = 1.0 - w
    nxt = torch.cat([amplitudes_frames[:, 1:], amplitudes_frames[:, -1:]], dim=1)
    # 2 pi (k + 1), each rounded once from float64, as the kernel's
    mult = (2.0 * math.pi * torch.arange(1, n_harm + 1, dtype=torch.float64)
            ).to(device=x.device, dtype=torch.float32)
    out = x.new_zeros(b, t, block_size)
    for start in range(0, n_harm, CHUNK):
        end = min(start + CHUNK, n_harm)
        amp = (amplitudes_frames[:, :, None, start:end] * omw
               + nxt[:, :, None, start:end] * w)
        out = out + torch.sum(torch.sin(mult[start:end] * xr) * amp.float(), dim=-1)
    return out.reshape(b, t * block_size)


class HarmonicBankFunction(torch.autograd.Function):
    """``impl(x, amplitudes, block_size)`` forward (the kernel, its
    operator, or the plain version in the CPU tests), backward through
    ``harmonic_bank_plain``."""

    @staticmethod
    def forward(ctx, impl, x, amplitudes_frames, block_size):
        ctx.block_size = block_size
        ctx.save_for_backward(x, amplitudes_frames)
        return impl(x, amplitudes_frames, block_size)

    @staticmethod
    def backward(ctx, grad_out):
        grads = kernels.plain_backward(
            lambda x, a: harmonic_bank_plain(x, a, ctx.block_size),
            ctx.saved_tensors, ctx.needs_input_grad[1:3], grad_out)
        return (None,) + grads + (None,)


def harmonic_bank(x: torch.Tensor, amplitudes_frames: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """x (B, L, 1) wrapped phase in cycles, amplitudes (B, T, n_harm) f32
    or bf16 (the bf16-amplitude mode) -> (B, L) f32, L = T * block.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``harmonic_bank.launches``); traced, the
    operator stands for either. The launch and the operator run inside
    ``HarmonicBankFunction`` when grad is on and an input requires it (the
    operator has no autograd kernel)."""
    if kernels.traced():
        impl = _HARMONIC_BANK
    elif x.device.type == "cpu":
        return harmonic_bank_plain(x, amplitudes_frames, block_size)
    else:
        impl = _launch
    if kernels.grad_wanted(x, amplitudes_frames):
        return HarmonicBankFunction.apply(impl, x, amplitudes_frames,
                                          int(block_size))
    return impl(x, amplitudes_frames, int(block_size))


def _harmonic_bank_fake(x, amplitudes_frames, block_size):
    b, t, _ = amplitudes_frames.shape
    return x.new_empty(b, t * block_size, dtype=torch.float32)


def _launch(x, amplitudes_frames, block_size):
    kernels.check_cuda_input(x, "harmonic_bank x", 3)
    bf16 = amplitudes_frames.dtype == torch.bfloat16
    kernels.check_cuda_input(amplitudes_frames, "harmonic_bank amplitudes", 3,
                             torch.bfloat16 if bf16 else torch.float32)
    b, t, n_harm = amplitudes_frames.shape
    if x.shape != (b, t * block_size, 1):
        raise ValueError(f"harmonic_bank: x must be ({b}, {t * block_size}, 1), "
                         f"got {tuple(x.shape)}")
    if x.device != amplitudes_frames.device:
        raise ValueError("harmonic_bank: x and amplitudes on different devices")
    out = torch.empty(b, t * block_size, device=x.device, dtype=torch.float32)
    kernels.launch("harmonic_bank",
                   "ddsp_harmonic_bank_bf16amp" if bf16 else "ddsp_harmonic_bank",
                   x.device, x.data_ptr(), amplitudes_frames.data_ptr(),
                   out.data_ptr(), b, t, block_size, n_harm)
    kernels.count_launch(harmonic_bank)
    return out


harmonic_bank.launches = 0
_HARMONIC_BANK = kernels.register_op(
    "harmonic_bank(Tensor x, Tensor amplitudes_frames, int block_size) -> Tensor",
    lambda x, amps, block: harmonic_bank_plain(x, amps, block), _launch,
    _harmonic_bank_fake)
