"""K2: one NSF-HiFiGAN generator stage's resblock mean as CUDA kernels
(``csrc/resblock.cu``), its plain PyTorch version and its launch counter.

Replaces ddsp_svc_tpu/ops/pallas_resblock.py ``fused_resblock_group``.
Weights are in the torch Conv1d layout: per resblock, the six folded
(weight (C, C, k), bias (C,)) pairs in chain order (convs1_0, convs2_0,
convs1_1, ...). Activations are feature-last (B, L, C), as in JAX.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernels

LRELU_SLOPE = 0.1


def resblock_group_plain(x, rb_weights, kernel_sizes, dilations):
    """mean_j ResBlock1_j(x) in plain PyTorch (JAX ``_stock_group``)."""
    xc = x.transpose(1, 2)
    total = None
    for k, dils, rbw in zip(kernel_sizes, dilations, rb_weights):
        z = xc
        ci = 0
        for d in dils:
            t = z
            for dd in (d, 1):
                w, b = rbw[ci]
                ci += 1
                t = F.leaky_relu(t, LRELU_SLOPE)
                t = F.conv1d(t, w, b, padding=(k - 1) * dd // 2, dilation=dd)
            z = t + z
        total = z if total is None else total + z
    return (total / float(len(rb_weights))).transpose(1, 2)


def _check_weights(rb_weights, kernel_sizes, dilations, c, device):
    n_dil = len(dilations[0])
    if len(rb_weights) != len(kernel_sizes) or len(dilations) != len(kernel_sizes):
        raise ValueError("resblock_group: one weight list, kernel size and "
                         "dilation tuple per resblock")
    if any(len(d) != n_dil for d in dilations):
        raise ValueError("resblock_group: every resblock needs the same "
                         "number of dilations")
    for k, rbw in zip(kernel_sizes, rb_weights):
        if k % 2 == 0:
            raise ValueError(f"resblock_group: odd kernel sizes only, got {k}")
        if len(rbw) != 2 * n_dil:
            raise ValueError("resblock_group: two convs per dilation")
        for w, b in rbw:
            kernels.check_cuda_input(w, "resblock weight", 3)
            kernels.check_cuda_input(b, "resblock bias", 1)
            if tuple(w.shape) != (c, c, k) or tuple(b.shape) != (c,):
                raise ValueError(f"resblock_group: weight {tuple(w.shape)} / "
                                 f"bias {tuple(b.shape)} for C={c}, k={k}")
            if w.device != device:
                raise ValueError("resblock_group: weights on another device")


def resblock_group(x, rb_weights, kernel_sizes, dilations):
    """x (B, L, C) -> mean over the stage's ResBlock1 chains, (B, L, C).

    A CPU tensor takes the plain version; a CUDA tensor launches 18 conv
    kernels (one stage) and counts one launch in ``resblock_group.launches``.
    """
    if x.device.type == "cpu":
        return resblock_group_plain(x, rb_weights, kernel_sizes, dilations)
    kernels.check_cuda_input(x, "resblock_group x", 3)
    b, length, c = x.shape
    _check_weights(rb_weights, kernel_sizes, dilations, c, x.device)
    flat = [wb for rbw in rb_weights for wb in rbw]
    w_ptrs = (ctypes.c_void_p * len(flat))(*(w.data_ptr() for w, _ in flat))
    b_ptrs = (ctypes.c_void_p * len(flat))(*(bb.data_ptr() for _, bb in flat))
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds_flat = [d for dils in dilations for d in dils]
    ds = (ctypes.c_int * len(ds_flat))(*ds_flat)
    out = torch.empty_like(x)
    t_buf = torch.empty_like(x)
    z_buf = torch.empty_like(x)
    err = kernels.library().ddsp_resblock_group(
        x.data_ptr(), w_ptrs, b_ptrs, ks, ds, len(kernel_sizes),
        len(dilations[0]), out.data_ptr(), t_buf.data_ptr(), z_buf.data_ptr(),
        b, length, c, kernels.stream_handle(x.device))
    kernels.check(err, "resblock_group")
    resblock_group.launches += 1
    return out


resblock_group.launches = 0
