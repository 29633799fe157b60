"""Building blocks on feature-last (B, T, C) tensors (mirrors
ddsp_svc_tpu/models/nn.py: Conv1d, ConvTranspose1d, GroupNorm). Dense,
LayerNorm, glu and leaky_relu are torch's own ``nn.Linear``,
``nn.LayerNorm`` (eps 1e-5), ``F.glu`` and ``F.leaky_relu``, which act on
the last axis and compute the same functions.

Parameters are in the torch layout (Conv1d (out, in / groups, k),
ConvTranspose1d (in, out, k), Linear (out, in)); the modules transpose to
(B, C, T) around ``F.conv1d`` internally. ``WNLinear`` keeps a weight-
normed Dense as JAX trains it, direction and gain apart; the vocoder's
weight norm is folded when JAX params are loaded (io/jax_params.py).
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


class WNLinear(nn.Module):
    """The JAX ``Dense(weight_norm=True)`` (nn.py:303-326) as two trained
    parameters: ``weight_v`` (out, in), the JAX ``kernel_v`` transposed, and
    ``weight_g`` (out,), its ``kernel_g``; the weight is v * g / (||v|| +
    1e-12), the norm over the input axis of each output row, recomputed at
    every call so that gradients and optimizer moments live on v and g as in
    JAX."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_g = nn.Parameter(torch.empty(out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def weight(self) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.weight_v * self.weight_v, dim=1))
        return self.weight_v * (self.weight_g / (norm + 1e-12))[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight(), self.bias)


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


def random_init_(module: nn.Module, generator: torch.Generator,
                 training: bool = False) -> nn.Module:
    """Fill every parameter from ``generator`` with torch's default-init
    ranges: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv and linear weights
    and biases (JAX ``_kaiming_uniform_torch``), ones/zeros for norms,
    N(0, 1 / features) for embeddings (flax ``Embed``), a weight-normed layer's gain g = ||v|| (as JAX inits
    ``kernel_g``), and a FAVOR+ projection buffer (models/pcmer.py) drawn as
    the reference draws it. With ``training`` the draw is the JAX training
    init exactly: the denoisers' final projections (each module's
    ``ZERO_INIT`` children, NaiveV2Diff's and WaveNet's ``output_projection``)
    get zero weights. Without it no projection is left at zero, so a random
    serving model's denoiser does real work."""
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
            with torch.no_grad():  # flax Embed: N(0, 1 / features)
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 / math.sqrt(mod.weight.shape[1]))
            continue
        if isinstance(mod, WNLinear):
            bound = 1.0 / math.sqrt(mod.weight_v.shape[1])
            with torch.no_grad():
                for p in (mod.weight_v, mod.bias):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2.0
                             - 1.0) * bound)
                mod.weight_g.copy_(torch.linalg.norm(mod.weight_v, dim=1))
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
    if training:
        for mod in module.modules():
            for name in getattr(mod, "ZERO_INIT", ()):
                with torch.no_grad():
                    getattr(mod, name).weight.zero_()
    return module
