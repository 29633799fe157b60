"""K3: one NaiveV2Diff denoiser layer as CUDA kernels
(``csrc/conformer.cu``), its plain PyTorch version and its launch counter;
and B3, the same layer in JAX's bf16 class (``mxu_bf16=True``).

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

B3 (``conformer_layer_bf16``) rounds the three GEMMs' operands -- cond, h,
s and Wc, W1, W2 -- to bf16 (round to nearest even) and sums their products
in f32; every other value stays f32. Its weights are rounded once per model
(``bf16_gemm_weights``, cached by the caller on the parameters' version
counters). Its backward is the f32 chain, as JAX's ``_fused_layer_bwd``
differentiates ``_stock_layer`` at x's dtype (f32) whatever ``mxu_bf16``
is (pallas_conformer.py:166-173).

B5 (``conformer_layer_bf16_io``) is B3 on bf16 activations, as JAX runs
``fused_conformer_layer`` on a bf16 x (a bf16 model's trunk): x is read as
bf16 and widened to f32 (pallas_conformer.py:63), step_vec is cast to x's
type (:226), cond is rounded to bf16 as in B3 (it may already be bf16),
and the output is rounded once to bf16 (:102). Its backward is autograd
through the f32 chain at the widened x and cond with the incoming gradient
rounded to bf16, which is what JAX's ``_fused_layer_bwd`` differentiates
(``_stock_layer`` promotes a bf16 x to f32 against the f32 weights; its
``vjp(g.astype(x.dtype))`` then refuses the bf16 cotangent of that f32
output, so the JAX package cannot take this gradient itself); the
gradients of x (and of a bf16 cond) come back in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels


def _layer(x, cond, step_vec, weights, operand, x_out=None):
    """The layer with each GEMM operand passed through ``operand``; the
    residual adds ``x_out`` (x by default)."""
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    h = x + step_vec[:, None, :] + torch.matmul(operand(cond), operand(wc).t()) + bc
    g = torch.matmul(operand(h), operand(w1).t()) + b1
    a, gate = g.chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    k = wd.shape[-1]
    v = F.conv1d(u.transpose(1, 2), wd[:, None, :], padding=(k - 1) // 2,
                 groups=u.shape[-1]).transpose(1, 2) + bd
    s = v * torch.sigmoid(v)
    return (x if x_out is None else x_out) + torch.matmul(operand(s), operand(w2).t()) + b2


def conformer_layer_plain(x, cond, step_vec, weights):
    """The layer in plain PyTorch (JAX ``_stock_layer``):
    h = x + step + cond Wc^T + bc; u = GLU(h W1^T + b1);
    v = depthwise(u) + bd; out = x + silu(v) W2^T + b2."""
    return _layer(x, cond, step_vec, weights, lambda t: t)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 (ties to even), back in f32."""
    return t.to(torch.bfloat16).float()


def conformer_layer_bf16_plain(x, cond, step_vec, weights):
    """B3 in plain PyTorch (JAX ``_layer_kernel`` with ``mxu_bf16``): the
    layer with cond, h, s and Wc, W1, W2 rounded to bf16 and f32 matmuls (a
    product of two bf16 values is exact in f32)."""
    return _layer(x, cond, step_vec, weights, bf16_round)


def bf16_gemm_weights(weights) -> tuple:
    """(Wc, W1, W2) of ``weights`` rounded to bf16, as B3 reads them."""
    wc, _, w1, _, _, _, w2, _ = weights
    with torch.no_grad():
        return tuple(w.detach().to(torch.bfloat16).contiguous()
                     for w in (wc, w1, w2))


# B3's tolerance against its plain version, or against the same function
# with exact (float64) sums, taken on the layer's branch (out - x): every
# element within BF16_LAYER_ATOL x max|branch|, and at most
# BF16_LAYER_MAX_BEYOND of the elements beyond BF16_LAYER_NEAR x max|branch|.
# h and s are rounded to bf16 after an f32 sum, and any other sum order
# flips some of those roundings: a flipped h moves a row of g by one bf16 ulp
# of h through W1, a flipped s a row of the output by one ulp of s through
# W2. On the CPU, torch's f32 sums and a split-K order sit at most 3.7e-4 x
# max|branch| from the exact sums (B 1, T 862 and B 4, T 172 at C 512, and
# a narrow layer), with no element beyond 2^-10; a planted extra bf16
# rounding of h before its bias, or of each GEMM's output, puts 16-21 % of
# the elements beyond 2^-10 (so does the f32 layer, which rounds nothing).
BF16_LAYER_ATOL = 2.0 ** -8
BF16_LAYER_NEAR = 2.0 ** -10
BF16_LAYER_MAX_BEYOND = 0.02


def bf16_layer_agreement(got: torch.Tensor, want: torch.Tensor,
                         x: torch.Tensor) -> dict:
    """How B3's output ``got`` agrees with a reference ``want`` for the
    layer input ``x``: ``ok`` (the tolerance above), ``beyond`` (the share
    of branch elements beyond BF16_LAYER_NEAR), ``rel`` (the largest
    difference over max|branch|) and ``max_abs_err``."""
    x = x.double().to(want.device)
    branch = want.double() - x
    diff = (got.double().to(want.device) - x - branch).abs()
    scale = float(branch.abs().max())
    beyond = float((diff > BF16_LAYER_NEAR * scale).double().mean())
    rel = float(diff.max()) / max(scale, 1e-30)
    return dict(ok=rel <= BF16_LAYER_ATOL and beyond <= BF16_LAYER_MAX_BEYOND,
                beyond=beyond, rel=rel,
                max_abs_err=float((got.double().to(want.device)
                                   - want.double()).abs().max()))


# B5's tolerance against its plain version or float64 sums: its output is
# x + branch rounded once to bf16, so B3's branch bound carries over with
# one bf16 ulp of the output added per element (a branch that differs in
# its last f32 bits moves the final rounding by one ulp), and the share of
# elements that differ at all, or by more than one ulp, is bounded. Against
# exact sums, torch's f32 sums on the CPU differ in 0.7-1.7 % of the
# elements (0.1-0.25 % beyond one ulp; B 1 x T 862 and B 4 x T 172 at
# C 512, a branch as large as x) and the kernel on an H100 in 0.36 % (0.04 %;
# B 48 x T 172, a branch a tenth of x). A planted extra bf16 rounding of h
# before its bias differs in 38-39 % (11 %) on the CPU and 9.9 % (1.6 %) on
# the card's inputs; the branch rounded to bf16 before x is added (the
# output rounded twice) in 24 % (4.6 %) and 8.7 % (0.97 %).
BF16_IO_MAX_DIFFER = 0.04
BF16_IO_MAX_BEYOND_ULP = 0.005


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (float64; normal numbers)."""
    t = t.double().abs()
    return torch.exp2(torch.floor(torch.log2(t.clamp_min(2.0 ** -126))) - 7)


def bf16_io_agreement(got: torch.Tensor, want: torch.Tensor,
                      x: torch.Tensor) -> dict:
    """How B5's bf16 output ``got`` agrees with a reference ``want`` for the
    layer input ``x``: ``ok`` (every element within BF16_LAYER_ATOL x
    max|branch| + one bf16 ulp of ``want``, at most BF16_IO_MAX_DIFFER of
    the elements differing and BF16_IO_MAX_BEYOND_ULP by more than one
    ulp), ``differ``, ``beyond_ulp``, ``rel`` (the largest difference over
    max|branch|) and ``max_abs_err``."""
    want = want.double()
    got = got.double().to(want.device)
    scale = float((want - x.double().to(want.device)).abs().max())
    ulp = bf16_ulp(want)
    diff = (got - want).abs()
    differ = float((diff > 0).double().mean())
    beyond = float((diff > ulp).double().mean())
    within = bool((diff <= BF16_LAYER_ATOL * scale + ulp).all())
    return dict(ok=within and differ <= BF16_IO_MAX_DIFFER
                and beyond <= BF16_IO_MAX_BEYOND_ULP,
                differ=differ, beyond_ulp=beyond,
                rel=float(diff.max()) / max(scale, 1e-30),
                max_abs_err=float(diff.max()))


def _check(x, cond, step_vec, weights, cond_dtype=torch.float32):
    b, t, c = x.shape
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    hc, inner, k = cond.shape[-1], wd.shape[0], wd.shape[-1]
    want = {"cond": (cond, (b, t, hc)), "step_vec": (step_vec, (b, c)),
            "wc": (wc, (c, hc)), "bc": (bc, (c,)),
            "w1": (w1, (2 * inner, c)), "b1": (b1, (2 * inner,)),
            "wd": (wd, (inner, k)), "bd": (bd, (inner,)),
            "w2": (w2, (c, inner)), "b2": (b2, (c,))}
    for name, (tensor, shape) in want.items():
        kernels.check_cuda_input(tensor, f"conformer_layer {name}", len(shape),
                                 cond_dtype if name == "cond" else torch.float32)
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
    """``impl(x, cond, step_vec, weights)`` forward (the kernel, its
    operator, or the plain version in the CPU tests), backward through
    ``conformer_layer_plain``."""

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
    one launch in ``conformer_layer.launches``. Traced (``kernels.traced``),
    the registered operator ``torch.ops.ddsp_svc.conformer_layer``
    (``kernels.OPS``) stands for either, one graph node. The launch and
    the operator run inside ``ConformerLayerFunction`` when grad is on and
    an input requires it (the operator has no autograd kernel)."""
    if kernels.traced():
        impl = _CONFORMER_LAYER
    elif x.device.type == "cpu":
        return conformer_layer_plain(x, cond, step_vec, weights)
    else:
        impl = _launch
    if kernels.grad_wanted(x, cond, step_vec, *weights):
        return ConformerLayerFunction.apply(impl, x, cond, step_vec, *weights)
    return impl(x, cond, step_vec, weights)


def _conformer_layer_fake(x, cond, step_vec, weights):
    return torch.empty_like(x)


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
    kernels.launch(
        "conformer_layer", "ddsp_conformer_layer", x.device,
        x.data_ptr(), cond.data_ptr(), step_vec.data_ptr(), wc.data_ptr(),
        bc.data_ptr(), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        h.data_ptr(), u.data_ptr(), s.data_ptr(), b, t, c, cond.shape[-1],
        inner, k)
    kernels.count_launch(conformer_layer)
    return out


conformer_layer.launches = 0
_CONFORMER_LAYER = kernels.register_op(
    "conformer_layer(Tensor x, Tensor cond, Tensor step_vec, Tensor[] weights) "
    "-> Tensor",
    lambda x, cond, step_vec, weights: conformer_layer_plain(x, cond, step_vec,
                                                             weights),
    _launch, _conformer_layer_fake)

# B3 reuses K3's Function: its forward launches the bf16 kernel, its
# backward is the same f32 plain chain
ConformerLayerBf16Function = ConformerLayerFunction


def conformer_layer_bf16(x, cond, step_vec, weights, packed=None):
    """B3: x (B, T, C), cond (B, T, Hc), step_vec (B, C) -> (B, T, C) f32.
    ``packed``: ``bf16_gemm_weights(weights)``, made here when None.

    A CPU tensor takes the plain version (through
    ``ConformerLayerBf16Function`` when grad is wanted, so the gradient is
    the f32 chain's); a CUDA tensor launches the bf16 kernel three times
    (h, then s with the GLU and the depthwise conv, then out) and counts
    one launch in ``conformer_layer_bf16.launches``."""
    if x.device.type == "cpu":
        if kernels.grad_wanted(x, cond, step_vec, *weights):
            return ConformerLayerBf16Function.apply(
                conformer_layer_bf16_plain, x, cond, step_vec,
                *weights)
        return conformer_layer_bf16_plain(x, cond, step_vec, weights)
    if packed is None:
        packed = bf16_gemm_weights(weights)

    def launch(x, cond, step_vec, weights):
        return _launch_bf16(x, cond, step_vec, weights, packed)

    if kernels.grad_wanted(x, cond, step_vec, *weights):
        return ConformerLayerBf16Function.apply(launch, x, cond, step_vec,
                                                *weights)
    return launch(x, cond, step_vec, weights)


def _check_bf16(x, cond, step_vec, weights, packed, name):
    """What B3 and B5 take beyond K3's checks: C, Hc and I multiples of 8,
    Hc at most 256, and bf16 copies of Wc, W1 and W2 on x's device."""
    _check(x, cond, step_vec, weights, cond.dtype)
    c, hc, inner = x.shape[-1], cond.shape[-1], weights[4].shape[0]
    if c % 8 or hc % 8 or inner % 8 or hc > 256:
        raise ValueError(f"{name}: C, Hc and I multiples of 8, Hc at most "
                         f"256, got {c}, {hc}, {inner}")
    for wname, p, w in zip(("wc", "w1", "w2"), packed,
                           (weights[0], weights[2], weights[6])):
        kernels.check_cuda_input(p, f"{name} {wname} (bf16)", 2, torch.bfloat16)
        if p.shape != w.shape or p.device != x.device:
            raise ValueError(f"{name}: packed {wname} does not match its weight")


def _launch_bf16(x, cond, step_vec, weights, packed):
    kernels.check_cuda_input(x, "conformer_layer_bf16 x", 3)
    _check_bf16(x, cond, step_vec, weights, packed, "conformer_layer_bf16")
    b, t, c = x.shape
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    inner, k = wd.shape
    out = torch.empty_like(x)
    # h and s in bf16, as the next GEMM reads them (u stays on the SM)
    h = torch.empty((b, t, c), device=x.device, dtype=torch.bfloat16)
    s = torch.empty((b, t, inner), device=x.device, dtype=torch.bfloat16)
    pc, p1, p2 = packed
    kernels.launch(
        "conformer_layer_bf16", "ddsp_conformer_layer_bf16", x.device,
        x.data_ptr(), cond.data_ptr(), step_vec.data_ptr(), pc.data_ptr(),
        bc.data_ptr(), p1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), p2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        h.data_ptr(), s.data_ptr(), b, t, c, cond.shape[-1], inner, k)
    kernels.count_launch(conformer_layer_bf16)
    return out


conformer_layer_bf16.launches = 0


def conformer_layer_bf16_io_plain(x, cond, step_vec, weights):
    """B5 in plain PyTorch: B3's chain on x and cond widened to f32 and
    step_vec rounded to bf16, the output rounded once to bf16."""
    return _layer(x.float(), cond.float(), bf16_round(step_vec), weights,
                  bf16_round).to(torch.bfloat16)


def _bf16_io_chain(x, cond, step_vec, *weights):
    """What B5's backward differentiates: the f32 layer at the widened x
    and cond (JAX ``_stock_layer`` with a bf16 x and f32 weights). x is
    widened at each of its two uses, as JAX promotes it at each: its two
    gradients are rounded to bf16 apart and summed in bf16."""
    return _layer(x.float(), cond.float(), step_vec, weights, lambda t: t,
                  x_out=x.float())


class ConformerLayerBf16IoFunction(torch.autograd.Function):
    """``impl(x, cond, step_vec, weights)`` forward (B5; its plain version
    on the CPU), backward through ``_bf16_io_chain`` with the bf16
    gradient of the output widened exactly to f32."""

    @staticmethod
    def forward(ctx, impl, x, cond, step_vec, *weights):
        ctx.save_for_backward(x, cond, step_vec, *weights)
        return impl(x, cond, step_vec, weights)

    @staticmethod
    def backward(ctx, grad_out):
        grads = kernels.plain_backward(_bf16_io_chain, ctx.saved_tensors,
                                       ctx.needs_input_grad[1:],
                                       grad_out.to(torch.bfloat16).float())
        return (None,) + grads


def conformer_layer_bf16_io(x, cond, step_vec, weights, packed=None):
    """B5: x (B, T, C) bf16, cond (B, T, Hc) f32 or bf16, step_vec (B, C)
    f32 -> (B, T, C) bf16. ``packed``: ``bf16_gemm_weights(weights)``,
    made here when None.

    A CPU tensor takes the plain version (through
    ``ConformerLayerBf16IoFunction`` when grad is wanted); a CUDA tensor
    launches B5 (three launches, as B3) and counts one launch in
    ``conformer_layer_bf16_io.launches``, or raises."""
    if x.dtype != torch.bfloat16 or cond.dtype not in (torch.float32,
                                                       torch.bfloat16):
        raise ValueError(f"conformer_layer_bf16_io: bf16 x and f32 or bf16 "
                         f"cond, got {x.dtype}, {cond.dtype}")
    if x.device.type == "cpu":
        impl = lambda x, c, s, w: conformer_layer_bf16_io_plain(x, c, s, w)
    else:
        if packed is None:
            packed = bf16_gemm_weights(weights)
        impl = lambda x, c, s, w: _launch_bf16_io(x, c, s, w, packed)
    if kernels.grad_wanted(x, cond, step_vec, *weights):
        return ConformerLayerBf16IoFunction.apply(impl, x, cond, step_vec,
                                                  *weights)
    return impl(x, cond, step_vec, weights)


def _launch_bf16_io(x, cond, step_vec, weights, packed):
    kernels.check_cuda_input(x, "conformer_layer_bf16_io x", 3, torch.bfloat16)
    _check_bf16(x, cond, step_vec, weights, packed, "conformer_layer_bf16_io")
    c16 = cond.dtype == torch.bfloat16
    b, t, c = x.shape
    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    inner, k = wd.shape
    out = torch.empty_like(x)
    h = torch.empty((b, t, c), device=x.device, dtype=torch.bfloat16)
    s = torch.empty((b, t, inner), device=x.device, dtype=torch.bfloat16)
    # JAX casts step_vec to x's type before the kernel reads it
    step = step_vec.detach().to(torch.bfloat16).float().contiguous()
    pc, p1, p2 = packed
    kernels.launch(
        "conformer_layer_bf16_io", "ddsp_conformer_layer_bf16_io", x.device,
        x.data_ptr(), cond.data_ptr(), int(c16), step.data_ptr(),
        pc.data_ptr(), bc.data_ptr(), p1.data_ptr(), b1.data_ptr(),
        wd.data_ptr(), bd.data_ptr(), p2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), h.data_ptr(), s.data_ptr(), b, t, c, cond.shape[-1],
        inner, k)
    kernels.count_launch(conformer_layer_bf16_io)
    return out


conformer_layer_bf16_io.launches = 0
