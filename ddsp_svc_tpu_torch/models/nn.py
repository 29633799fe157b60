"""Building blocks on feature-last (B, T, C) tensors (mirrors
ddsp_svc_tpu/models/nn.py: Conv1d, ConvTranspose1d, GroupNorm). Dense,
LayerNorm, glu and leaky_relu are torch's own ``nn.Linear``,
``nn.LayerNorm`` (eps 1e-5), ``F.glu`` and ``F.leaky_relu``, which act on
the last axis and compute the same functions.

Parameters are in the torch layout (Conv1d (out, in / groups, k),
ConvTranspose1d (in, out, k), Linear (out, in)); the modules transpose to
(B, C, T) around ``F.conv1d`` internally. Weight norm is folded when JAX
params are loaded (io/jax_params.py), so no module here carries it.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv1d(nn.Module):
    """torch.nn.Conv1d semantics on (B, T, C_in) -> (B, T_out, C_out).

    The call's ``dtype``: the type the conv runs in, as the JAX Conv1d's
    ``dtype`` (nn.py:98-110): x and the weight cast to it, convolved, then
    the bias cast to it added (a separate rounding in bf16). Parameters stay
    float32. None: x's own type."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dtype = dtype or x.dtype
        if dtype == self.weight.dtype:
            y = F.conv1d(x.transpose(1, 2).to(dtype), self.weight, self.bias,
                         self.stride, self.padding, self.dilation, self.groups)
            return y.transpose(1, 2)
        y = F.conv1d(x.transpose(1, 2).to(dtype), self.weight.to(dtype), None,
                     self.stride, self.padding, self.dilation, self.groups)
        y = y.transpose(1, 2)
        return y if self.bias is None else y + self.bias.to(dtype)


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d on (B, T, C): out_len = (T-1)*stride - 2*pad + k.
    The weight is (in, out, k): the JAX kernel (k, in, out) permuted
    (1, 2, 0), unflipped (the JAX flip belongs to its lhs-dilated lowering).
    The call's ``dtype`` as in ``Conv1d``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dtype = dtype or x.dtype
        if dtype == self.weight.dtype:
            y = F.conv_transpose1d(x.transpose(1, 2).to(dtype), self.weight,
                                   self.bias, self.stride, self.padding)
            return y.transpose(1, 2)
        y = F.conv_transpose1d(x.transpose(1, 2).to(dtype), self.weight.to(dtype),
                               None, self.stride, self.padding)
        return y.transpose(1, 2) + self.bias.to(dtype)


class GroupNorm(nn.Module):
    """torch GroupNorm (eps 1e-5) on (B, T, C): statistics over time and the
    channels of each group."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.transpose(1, 2), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.transpose(1, 2)


def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator`` with torch's default-init
    ranges: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv and linear weights
    and biases, ones/zeros for norms, N(0, 1) for embeddings, and a FAVOR+
    projection buffer (models/pcmer.py) drawn as the reference draws it.
    Unlike the JAX init, no projection is left at zero."""
    for mod in module.modules():
        if hasattr(mod, "redraw_projection_matrix"):
            mod.redraw_projection_matrix(generator)
        params = dict(mod.named_parameters(recurse=False))
        if not params:
            continue
        if isinstance(mod, (nn.LayerNorm, GroupNorm)):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
            continue
        if isinstance(mod, nn.Embedding):
            with torch.no_grad():
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator))
            continue
        w = params["weight"]
        if isinstance(mod, ConvTranspose1d):
            fan_in = w.shape[1] * w.shape[2]  # torch's fan_in for (in, out, k)
        else:
            fan_in = math.prod(w.shape[1:])
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            for p in params.values():
                p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0)
                        * bound)
    return module
