"""Building blocks on feature-last (B, T, C) tensors (mirrors
ddsp_svc_tpu/models/nn.py: Conv1d, Conv2d, ConvTranspose1d, Dense,
LayerNorm, GroupNorm and ``_spectral_normalize``; ConvTranspose2d and the
f0 nets' eval-mode BatchNorm, which act on channels-first tensors as the
f0 nets run). glu and leaky_relu are torch's ``F.glu`` and
``F.leaky_relu``, which act on the last axis.

Parameters are in the torch layout (Conv1d (out, in / groups, k), Conv2d
(out, in, kh, kw), ConvTranspose1d (in, out, k), Linear (out, in)); the
modules transpose to channels-first around ``F.conv*`` internally.
``WNLinear`` keeps a weight-normed Dense as JAX trains it, direction and
gain apart, and so do the convs built with ``weight_norm=True`` (the
vocoder in training; its serving copy folds them at load,
io/jax_params.py).

Mixed precision: the layers JAX gives a ``dtype`` (Conv1d, Conv2d,
ConvTranspose1d, Dense, WNLinear) carry a ``compute_dtype`` (None: x's own
type). x and the weight are cast to it, multiplied, and the bias cast to it
is added after (a separate rounding in bf16, as JAX adds it); parameters
stay float32. ``set_compute_dtype`` sets it on every such layer of a model,
as the JAX models pass ``dtype=self.dtype`` to each. LayerNorm and
GroupNorm take no dtype in JAX: on a bf16 x their statistics are bf16 (from
f32 sums), the normalisation runs in bf16, and the f32 scale and bias
promote the result to float32, as here.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _polyphase_weight(weight: torch.Tensor, stride: tuple) -> torch.Tensor:
    """A transposed convolution's weight (in, out, *k) as the weight of the
    forward convolution that computes its ``stride`` phases: (out * prod
    (stride), in, *J), J = ceil(k / s) per axis, phase r's taps w[j s + r]
    in reverse order, out-major."""
    nd = weight.dim() - 2
    cin, cout, ks = weight.shape[0], weight.shape[1], weight.shape[2:]
    js = [-(-k // s) for k, s in zip(ks, stride)]
    pad = []
    for k, s, j in reversed(list(zip(ks, stride, js))):
        pad += [0, j * s - k]
    shape = [cin, cout]
    for j, s in zip(js, stride):
        shape += [j, s]
    w = F.pad(weight, pad).reshape(shape).flip([2 + 2 * i for i in range(nd)])
    perm = ([1] + [3 + 2 * i for i in range(nd)] + [0]
            + [2 + 2 * i for i in range(nd)])
    return w.permute(perm).reshape(cout * math.prod(stride), cin, *js)


def conv_transpose(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None, stride, padding,
                   output_padding=0) -> torch.Tensor:
    """``F.conv_transpose1d`` / ``conv_transpose2d`` on channels-first x
    (no dilation, one group). On a CUDA tensor it runs as one forward
    convolution over the stride's polyphase components, interleaved after:
    cuDNN's transposed convolutions may accumulate with atomics, so the
    same call on the same input could return other bits (ROADMAP C(kk)),
    while its forward convolutions return the same ones. The products
    summed are the same; their order is the forward convolution's."""
    if x.is_cuda:
        return polyphase_conv_transpose(x, weight, bias, stride, padding,
                                        output_padding)
    conv_t = (F.conv_transpose1d, F.conv_transpose2d)[x.dim() - 3]
    return conv_t(x, weight, bias, stride, padding, output_padding)


def polyphase_conv_transpose(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor | None, stride, padding,
                             output_padding=0) -> torch.Tensor:
    """``conv_transpose``'s CUDA route on any device: the forward
    convolution of ``_polyphase_weight`` over x padded by J - 1 on each
    side gives output position q s + r of the unpadded transposed
    convolution in phase r; the phases are interleaved, ``padding`` is
    cropped and ``output_padding`` filled with zeros past the last tap."""
    nd = x.dim() - 2
    tup = (lambda v: (v,) * nd if isinstance(v, int) else tuple(v))
    stride, padding, output_padding = tup(stride), tup(padding), tup(output_padding)
    w = _polyphase_weight(weight, stride)
    js = w.shape[2:]
    y = (F.conv1d, F.conv2d)[nd - 1](x, w, None, 1, [j - 1 for j in js])
    b, cout, qs = x.shape[0], weight.shape[1], y.shape[2:]
    y = y.reshape(b, cout, *stride, *qs)  # (B, out, s.., q..) -> (B, out, q s ..)
    perm = [0, 1] + [i for a in range(nd) for i in (2 + nd + a, 2 + a)]
    y = y.permute(perm).reshape(b, cout, *(q * s for q, s in zip(qs, stride)))
    out = [(t - 1) * s - 2 * p + k + op for t, s, p, k, op in zip(
        x.shape[2:], stride, padding, weight.shape[2:], output_padding)]
    short = [max(0, p + o - n) for p, o, n in zip(padding, out, y.shape[2:])]
    if any(short):  # output padding past the last tap: zeros
        y = F.pad(y, [v for sh in reversed(short) for v in (0, sh)])
    y = y[(slice(None), slice(None)) + tuple(
        slice(p, p + o) for p, o in zip(padding, out))]
    return y if bias is None else y + bias.reshape(1, -1, *([1] * nd))


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    """||v|| over every axis but the first, shaped to broadcast against v."""
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


@functools.lru_cache(maxsize=None)
def _start_vector(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    from ..ops.jax_random import normal_key0

    return torch.tensor(normal_key0(n), device=device, dtype=dtype)


def spectral_normalize(w: torch.Tensor, n_iter: int = 5) -> torch.Tensor:
    """JAX ``_spectral_normalize`` (nn.py:36-53) on a torch-layout weight
    (out, ...): ``n_iter`` power iterations from the fixed start vector
    ``jax.random.normal(PRNGKey(0), (out,))`` (``ops/jax_random``) at every
    call, differentiated through as JAX does; w / sigma."""
    out = w.shape[0]
    m = w.reshape(out, -1)
    u = _start_vector(out, w.device, w.dtype)

    def l2(v):
        return v / (torch.linalg.norm(v) + 1e-12)

    u = l2(u)
    v = l2(m.t() @ u)
    for _ in range(n_iter):
        v = l2(m.t() @ u)
        u = l2(m @ v)
    return w / (u @ (m @ v))


class _Weighted(nn.Module):
    """The weight of a conv: plain (``weight``), weight-normed as JAX
    trains it (``weight_v`` and ``weight_g``, the norm over every axis but
    the first with +1e-12, folded at every call: per output channel of a
    conv, per input channel of a transposed conv, whose torch layout puts
    it first), or spectral-normed at every call."""

    def _make_weight(self, shape, weight_norm: bool, spectral_norm: bool) -> None:
        self.weight_norm, self.spectral_norm = weight_norm, spectral_norm
        if weight_norm:
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.empty(shape[0]))
        else:
            self.weight = nn.Parameter(torch.empty(shape))

    def folded_weight(self) -> torch.Tensor:
        if self.weight_norm:
            v = self.weight_v
            g = self.weight_g.reshape((-1,) + (1,) * (v.dim() - 1))
            return v * (g / (_norm_rows(v) + 1e-12))
        if self.spectral_norm:
            return spectral_normalize(self.weight)
        return self.weight


class Conv1d(_Weighted):
    """torch.nn.Conv1d semantics on (B, T, C_in) -> (B, T_out, C_out), with
    JAX's optional weight norm (as (v, g)) or spectral norm.

    The type the conv runs in: the call's ``dtype``, else the layer's
    ``compute_dtype``, else x's own (the JAX Conv1d's ``dtype``,
    nn.py:98-110): x and the weight cast to it, convolved, then the bias
    cast to it added (a separate rounding in bf16). Parameters stay
    float32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True, weight_norm: bool = False,
                 spectral_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.compute_dtype = None
        self._make_weight((out_channels, in_channels // groups, kernel_size),
                          weight_norm, spectral_norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dtype = dtype or self.compute_dtype or x.dtype
        weight = self.folded_weight()
        if dtype == weight.dtype:
            y = F.conv1d(x.transpose(1, 2).to(dtype), weight, self.bias,
                         self.stride, self.padding, self.dilation, self.groups)
            return y.transpose(1, 2)
        y = F.conv1d(x.transpose(1, 2).to(dtype), weight.to(dtype), None,
                     self.stride, self.padding, self.dilation, self.groups)
        y = y.transpose(1, 2)
        return y if self.bias is None else y + self.bias.to(dtype)


class Conv2d(_Weighted):
    """torch.nn.Conv2d on (B, H, W, C_in) -> (B, H', W', C_out) (JAX
    ``Conv2d``, the period discriminators' conv), with weight norm as
    (v, g) or spectral norm; ``padding`` ((top, bottom), (left, right)).
    The type it runs in as ``Conv1d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1), padding=((0, 0), (0, 0)), weight_norm: bool = False,
                 spectral_norm: bool = False):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(map(tuple, padding))
        self.compute_dtype = None
        self._make_weight((out_channels, in_channels, *kernel_size),
                          weight_norm, spectral_norm)
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        (pt, pb), (pl, pr) = self.padding
        x = F.pad(x.permute(0, 3, 1, 2).to(dtype), (pl, pr, pt, pb))
        weight = self.folded_weight()
        if dtype == weight.dtype:
            y = F.conv2d(x, weight, self.bias, self.stride)
            return y.permute(0, 2, 3, 1)
        y = F.conv2d(x, weight.to(dtype), None, self.stride).permute(0, 2, 3, 1)
        return y + self.bias.to(dtype)


class ConvTranspose1d(_Weighted):
    """torch.nn.ConvTranspose1d on (B, T, C): out_len = (T-1)*stride - 2*pad + k.
    The weight is (in, out, k): the JAX kernel (k, in, out) permuted
    (1, 2, 0), unflipped (the JAX flip belongs to its lhs-dilated lowering).
    Weight norm, as (v, g), is per *input* channel (JAX nn.py:216-222). The
    type it runs in as ``Conv1d``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.compute_dtype = None
        self._make_weight((in_channels, out_channels, kernel_size), weight_norm,
                          False)
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dtype = dtype or self.compute_dtype or x.dtype
        weight = self.folded_weight()
        if dtype == weight.dtype:
            y = conv_transpose(x.transpose(1, 2).to(dtype), weight, self.bias,
                               self.stride, self.padding)
            return y.transpose(1, 2)
        y = conv_transpose(x.transpose(1, 2).to(dtype), weight.to(dtype), None,
                           self.stride, self.padding)
        return y.transpose(1, 2) + self.bias.to(dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch.nn.ConvTranspose2d on channels-first (B, C, H, W) (the JAX
    ``ConvTranspose2d``, nn.py:259-300, on (B, H, W, C)): out = (in - 1) *
    stride - 2 * pad + k + output_padding per spatial axis. The weight (in,
    out, kh, kw) is the JAX kernel (kh, kw, in, out) permuted (2, 3, 0, 1),
    unflipped, as ``ConvTranspose1d``'s. Computed by ``conv_transpose``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose(x, self.weight, self.bias, self.stride,
                              self.padding, self.output_padding)


class BatchNorm(nn.Module):
    """An eval-mode BatchNorm over axis 1 of a channels-first tensor (flax
    ``BatchNorm(use_running_average=True)``): (x - mean) * rsqrt(var + eps)
    * weight + bias, with the running ``mean`` and ``var`` the JAX
    ``batch_stats`` and ``weight`` / ``bias`` its ``scale`` / ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(self.var + self.eps) * self.weight
        return (x - self.mean.reshape(shape)) * scale.reshape(shape) \
            + self.bias.reshape(shape)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(v) rounded once to v's type (torch's bf16 rsqrt on the CPU
    rounds the square root first; XLA's does not)."""
    return torch.rsqrt(v.float()).to(v.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with the JAX Dense's type rule: it runs in
    ``compute_dtype`` or x's own type, the bias added after the product's
    rounding when that type is not the weight's."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        if dtype == self.weight.dtype:
            return F.linear(x.to(dtype), self.weight, self.bias)
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class LayerNorm(nn.LayerNorm):
    """torch LayerNorm (eps 1e-5) over the last axis; on a bf16 x the JAX
    ``LayerNorm``'s arithmetic (nn.py:329-342): mean and variance from f32
    sums rounded to bf16, (x - mean) * rsqrt(var + eps) in bf16, then the
    f32 scale and bias (a float32 result)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return super().forward(x)
        mean = x.float().mean(-1, keepdim=True).to(x.dtype)
        var = x.float().var(-1, unbiased=False, keepdim=True).to(x.dtype)
        y = (x - mean) * _rsqrt(var + weak(self.eps, var))
        return y * self.weight + self.bias


class WNLinear(nn.Module):
    """The JAX ``Dense(weight_norm=True)`` (nn.py:303-326) as two trained
    parameters: ``weight_v`` (out, in), the JAX ``kernel_v`` transposed, and
    ``weight_g`` (out,), its ``kernel_g``; the weight is v * g / (||v|| +
    1e-12), the norm over the input axis of each output row, recomputed at
    every call so that gradients and optimizer moments live on v and g as in
    JAX."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.compute_dtype = None
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_g = nn.Parameter(torch.empty(out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def weight(self) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.weight_v * self.weight_v, dim=1))
        return self.weight_v * (self.weight_g / (norm + 1e-12))[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        if dtype == torch.float32:
            return F.linear(x.to(dtype), self.weight(), self.bias)
        return F.linear(x.to(dtype), self.weight().to(dtype)) + self.bias.to(dtype)


def weak(value: float, like: torch.Tensor):
    """A Python scalar as JAX combines it with ``like``: JAX types a Python
    number weakly, so against a bf16 array it is rounded to bf16 first;
    torch keeps it in f32 against a bf16 tensor. On float32 the number
    itself."""
    if like.dtype == torch.float32:
        return value
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# JAX's activations on a bf16 x, as the CPU backend computes them: every op
# of the function's own definition rounded to bf16 (jax.nn.sigmoid is
# 1 / (1 + exp(-x)), gelu 0.5 x erfc(-x sqrt(1/2)) with sqrt(1/2) in bf16,
# softplus logaddexp(x, 0)), where torch's bf16 ops round once from f32. On
# float32 they are torch's own functions.
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


def glu(x: torch.Tensor) -> torch.Tensor:
    """a * sigmoid(b) over the last axis's halves."""
    if x.dtype == torch.float32:
        return F.glu(x, dim=-1)
    a, b = x.chunk(2, dim=-1)
    return a * sigmoid(b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return (0.5 * x) * torch.special.erfc(-x * half)


def softplus(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return F.softplus(x)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


class GroupNorm(nn.Module):
    """torch GroupNorm (eps 1e-5) on (B, T, C): statistics over time and the
    channels of each group.

    Time-sharded (``parallel/``): ``frame_mask`` (B, T, 1), 1 on the block's
    own frames and 0 on its halo, and ``group`` (a ``parallel.mesh.
    TimeGroup``) take the statistics over the own frames of every rank, in
    two passes (the masked mean, then the masked centred second moment),
    each summed over the group (JAX ``GroupNorm(frame_mask, axis_name)``,
    nn.py:345-390)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _masked(self, x, frame_mask, group) -> torch.Tensor:
        b, t, c = x.shape
        xg = x.reshape(b, t, self.num_groups, c // self.num_groups)
        m = (torch.ones((b, t, 1, 1), dtype=x.dtype, device=x.device)
             if frame_mask is None else frame_mask.reshape(b, t, 1, 1).to(x.dtype))
        cnt = torch.sum(m, dim=1, keepdim=True) * (c // self.num_groups)
        s1 = torch.sum(xg * m, dim=(1, 3), keepdim=True)
        if group is not None:
            cnt, s1 = group.psum(cnt), group.psum(s1)
        mean = s1 / cnt
        d2 = torch.sum((xg - mean) * (xg - mean) * m, dim=(1, 3), keepdim=True)
        if group is not None:
            d2 = group.psum(d2)
        var = d2 / cnt
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return y * self.weight + self.bias

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None,
                group=None) -> torch.Tensor:
        if frame_mask is not None or group is not None:
            return self._masked(x, frame_mask, group)
        if x.dtype == torch.float32:
            y = F.group_norm(x.transpose(1, 2), self.num_groups, self.weight,
                             self.bias, self.eps)
            return y.transpose(1, 2)
        # a bf16 x as JAX (nn.py:345-390): bf16 statistics from f32 sums,
        # the normalisation in bf16, the f32 scale and bias promote to f32
        b, t, c = x.shape
        xg = x.reshape(b, t, self.num_groups, c // self.num_groups)
        mean = xg.float().mean((1, 3), keepdim=True).to(x.dtype)
        var = xg.float().var((1, 3), unbiased=False, keepdim=True).to(x.dtype)
        y = ((xg - mean) * _rsqrt(var + weak(self.eps, var))).reshape(b, t, c)
        return y * self.weight + self.bias


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
        w = params["weight_v"] if "weight_v" in params else params["weight"]
        if isinstance(mod, ConvTranspose1d):
            fan_in = w.shape[1] * w.shape[2]  # torch's fan_in for (in, out, k)
        else:
            fan_in = math.prod(w.shape[1:])
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            for name, p in params.items():
                if name != "weight_g":
                    p.copy_((torch.rand(p.shape, generator=generator) * 2.0
                             - 1.0) * bound)
            if "weight_g" in params:  # g = ||v||, as JAX inits kernel_g
                params["weight_g"].copy_(_norm_rows(w).reshape(-1))
    if training:
        for mod in module.modules():
            for name in getattr(mod, "ZERO_INIT", ()):
                with torch.no_grad():
                    getattr(mod, name).weight.zero_()
    return module


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Set ``compute_dtype`` on every layer of ``module`` that JAX gives the
    model's ``dtype`` (Conv1d, Conv2d, ConvTranspose1d, Dense, WNLinear);
    None restores x's own type."""
    for mod in module.modules():
        if isinstance(mod, (Conv1d, Conv2d, ConvTranspose1d, Dense, WNLinear)):
            mod.compute_dtype = dtype
    return module
