"""K3: one NaiveV2Diff denoiser layer as CUDA kernels
(``csrc/conformer.cu``), its plain PyTorch version and its launch counter.

Replaces ddsp_svc_tpu/ops/pallas_conformer.py ``fused_conformer_layer``
(f32 mode). Weights are in the torch layout: ``(Wc (C, Hc), bc, W1 (2I, C),
b1, wd (I, k), bd, W2 (C, I), b2)``, which is the layout the kernel's
tiles want, so nothing is packed. Activations are feature-last. The GEMMs
multiply on the tensor cores in split TF32 at f32 accuracy (the scheme
``ops/cuda_resblock.tf32_split`` emulates).

With grad on, ``ConformerLayerFunction`` puts the kernel behind the JAX
package's custom VJP (``_fused_layer_bwd``, pallas_conformer.py:168-175):
the backward is autograd through ``conformer_layer_plain`` recomputed from
the saved x, cond, step_vec and the eight weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels


def conformer_layer_plain(x, cond, step_vec, weights):
    """The layer in plain PyTorch (JAX ``_stock_layer``):
    h = x + step + cond Wc^T + bc; u = GLU(h W1^T + b1);
    v = depthwise(u) + bd; out = x + silu(v) W2^T + b2."""
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    h = x + step_vec[:, None, :] + torch.matmul(cond, wc.t()) + bc
    g = torch.matmul(h, w1.t()) + b1
    a, gate = g.chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    k = wd.shape[-1]
    v = F.conv1d(u.transpose(1, 2), wd[:, None, :], padding=(k - 1) // 2,
                 groups=u.shape[-1]).transpose(1, 2) + bd
    s = v * torch.sigmoid(v)
    return x + torch.matmul(s, w2.t()) + b2


def _check(x, cond, step_vec, weights):
    b, t, c = x.shape
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    hc, inner, k = cond.shape[-1], wd.shape[0], wd.shape[-1]
    want = {"cond": (cond, (b, t, hc)), "step_vec": (step_vec, (b, c)),
            "wc": (wc, (c, hc)), "bc": (bc, (c,)),
            "w1": (w1, (2 * inner, c)), "b1": (b1, (2 * inner,)),
            "wd": (wd, (inner, k)), "bd": (bd, (inner,)),
            "w2": (w2, (c, inner)), "b2": (b2, (c,))}
    for name, (tensor, shape) in want.items():
        kernels.check_cuda_input(tensor, f"conformer_layer {name}", len(shape))
        if tuple(tensor.shape) != shape:
            raise ValueError(f"conformer_layer: {name} is {tuple(tensor.shape)}, "
                             f"expected {shape}")
        if tensor.device != x.device:
            raise ValueError(f"conformer_layer: {name} on another device")
    if k % 2 == 0 or k > 31:
        raise ValueError(f"conformer_layer: an odd depthwise kernel of at most "
                         f"31 taps, got {k}")
    if c % 4 or hc % 4 or inner % 4:
        raise ValueError(f"conformer_layer: C, Hc and I multiples of 4, got "
                         f"{c}, {hc}, {inner}")
    if any(t.data_ptr() % 16 for t in (x, cond, step_vec, *weights)):
        raise ValueError("conformer_layer: tensors must be 16-byte aligned")


class ConformerLayerFunction(torch.autograd.Function):
    """``impl(x, cond, step_vec, weights)`` forward (the kernel; the plain
    version in the CPU tests), backward through ``conformer_layer_plain``."""

    @staticmethod
    def forward(ctx, impl, x, cond, step_vec, *weights):
        ctx.save_for_backward(x, cond, step_vec, *weights)
        return impl(x, cond, step_vec, weights)

    @staticmethod
    def backward(ctx, grad_out):
        grads = kernels.plain_backward(
            lambda x, c, s, *w: conformer_layer_plain(x, c, s, w),
            ctx.saved_tensors, ctx.needs_input_grad[1:], grad_out)
        return (None,) + grads


def conformer_layer(x, cond, step_vec, weights):
    """x (B, T, C), cond (B, T, Hc), step_vec (B, C) -> (B, T, C).

    A CPU tensor takes the plain version; a CUDA tensor launches the layer's
    four kernels (three tensor-core GEMMs and the depthwise conv) and counts
    one launch in ``conformer_layer.launches``, through
    ``ConformerLayerFunction`` when grad is on and an input requires it."""
    if x.device.type == "cpu":
        return conformer_layer_plain(x, cond, step_vec, weights)
    if kernels.grad_wanted(x, cond, step_vec, *weights):
        return ConformerLayerFunction.apply(_launch, x, cond, step_vec, *weights)
    return _launch(x, cond, step_vec, weights)


def _launch(x, cond, step_vec, weights):
    kernels.check_cuda_input(x, "conformer_layer x", 3)
    _check(x, cond, step_vec, weights)
    b, t, c = x.shape
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    inner, k = wd.shape
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    u = torch.empty(b, t, inner, device=x.device, dtype=x.dtype)
    s = torch.empty_like(u)
    err = kernels.library().ddsp_conformer_layer(
        x.data_ptr(), cond.data_ptr(), step_vec.data_ptr(), wc.data_ptr(),
        bc.data_ptr(), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        h.data_ptr(), u.data_ptr(), s.data_ptr(), b, t, c, cond.shape[-1],
        inner, k, kernels.stream_handle(x.device))
    kernels.check(err, "conformer_layer")
    kernels.count_launch(conformer_layer)
    return out


conformer_layer.launches = 0
