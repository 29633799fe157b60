"""K2: one NSF-HiFiGAN generator stage's resblock mean as CUDA kernels
(``csrc/resblock.cu``), its plain PyTorch version and its launch counter.

Replaces ddsp_svc_tpu/ops/pallas_resblock.py ``fused_resblock_group``.
Weights are in the torch Conv1d layout: per resblock, the six folded
(weight (C, C, k), bias (C,)) pairs in chain order (convs1_0, convs2_0,
convs1_1, ...). Activations are feature-last (B, L, C), as in JAX.

The kernel reads each conv weight split into TF32 hi and lo planes and
packed as wgmma B tiles (``pack_conv_weight``, ``PackedResblocks``). A
caller that serves many requests packs once per model and passes the
``PackedResblocks`` in place of the nested list
(``models/nsf_hifigan.Generator`` does); a nested list is packed on every
call. The kernel multiplies on the tensor cores in split TF32 at f32
accuracy; ``tf32_split``, ``unpack_conv_weight`` and ``conv_packed_plain``
are its arithmetic in plain PyTorch, for the tests.

With grad on, ``ResblockGroupFunction`` puts the kernel behind the JAX
package's custom VJP (``_fused_group_bwd``, pallas_resblock.py:343-350):
the backward is autograd through ``resblock_group_plain`` recomputed from
the saved x and the torch-layout weights, which take the gradients; the
packed copy takes none.

K2's bf16 class (the JAX kernel run on bf16 activations under
``--voc_bf16``) is ``resblock_group_bf16``: bf16 x and out, bf16 weights
packed once per model (``pack_conv_weight_bf16``), f32 accumulation, bias,
residuals and mean; ``resblock_group_bf16_plain`` is its plain version and
``resblock_group`` dispatches to it on a bf16 x. It counts its launches in
``resblock_group_bf16.launches``. Its kernel keeps a time tile and its halo
on the SM through a run of convs (``FUSED_PLAN``: the whole stage at C <=
64, a conv pair at C = 128); ``resblock_group_bf16_tiled`` walks the same
tiles, halos and zero padding in plain PyTorch, for the tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import kernels

LRELU_SLOPE = 0.1


def resblock_group_plain(x, rb_weights, kernel_sizes, dilations):
    """mean_j ResBlock1_j(x) in plain PyTorch (JAX ``_stock_group``)."""
    if isinstance(rb_weights, PackedResblocks):
        rb_weights = rb_weights.torch_weights
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


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def resblock_group_bf16_plain(x, rb_weights, kernel_sizes, dilations):
    """K2's bf16 class in plain PyTorch (JAX ``_rb_group_kernel`` with bf16
    x and weights): each conv's input leaky'd in f32 and rounded to bf16,
    the weights rounded to bf16, f32 convs (a bf16 x bf16 product is exact
    in f32), the f32 bias, residuals and mean, one rounding to bf16 at the
    end. x (B, L, C) bf16 -> (B, L, C) bf16."""
    if isinstance(rb_weights, PackedResblocks):
        rb_weights = rb_weights.torch_weights
    xc = x.float().transpose(1, 2)
    total = None
    for k, dils, rbw in zip(kernel_sizes, dilations, rb_weights):
        z = xc
        ci = 0
        for d in dils:
            t = z
            for dd in (d, 1):
                w, b = rbw[ci]
                ci += 1
                t = _bf16_round(F.leaky_relu(t, LRELU_SLOPE))
                t = F.conv1d(t, _bf16_round(w), b.float(),
                             padding=(k - 1) * dd // 2, dilation=dd)
            z = t + z
        total = z if total is None else total + z
    out = total / float(len(rb_weights))
    return out.transpose(1, 2).to(torch.bfloat16)


# K2-bf16's tolerance against its plain version (or against the same
# function with exact sums): per element one bf16 ulp of the reference
# value plus BF16_ATOL x max|ref|; at most BF16_MAX_BEYOND_ULP of the
# elements beyond one ulp; at most BF16_MAX_DIFFER of them differing at all.
# Any other f32 sum order flips some of the bf16 roundings of the conv
# inputs; a flipped activation moves by one bf16 ulp of its own size and
# carries through the convs after it, so an output element can move by
# about one ulp of the typical activation whatever its own size. Two plain
# f32 sum orders on the CPU (tests/test_torch_bf16.py, and chip_smoke.py
# phase 3 at the 10 s shapes) differ from the exact sums in this way in
# 0.1-2.5 % of the elements. A planted extra bf16 rounding of the chains'
# sums or of the conv outputs moves 17-34 % of the elements, which
# BF16_MAX_DIFFER rejects.
BF16_ATOL = 2.0 ** -7
BF16_MAX_BEYOND_ULP = 0.02
BF16_MAX_DIFFER = 0.10


def bf16_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How a bf16 result agrees with its reference: ``ok`` (the tolerance
    above), ``differ`` (the share of elements that differ at all),
    ``beyond_ulp`` (the share beyond one ulp) and ``max_abs_err``."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    beyond = float((diff > ulp).double().mean())
    differ = float((diff > 0).double().mean())
    ok = (bool((diff <= ulp + BF16_ATOL * want.abs().max()).all())
          and beyond <= BF16_MAX_BEYOND_ULP and differ <= BF16_MAX_DIFFER)
    return dict(ok=ok, differ=differ, beyond_ulp=beyond,
                max_abs_err=float(diff.max()))


# K2-bf16's launch plan per width: (convs per launch, the most output rows
# a block takes). "stage": one launch runs the three chains one after
# another; "chain" and "pair" launch per chain or per conv pair, with z in
# f32 in device memory between a chain's pairs.
# C = 128 takes a pair: a chain's 120-row halo does not fit beside a useful
# tile there. FUSED_BLOCKS_PER_SM: how many blocks share an SM (their
# shared memory; FusedCfg's MIN_BLOCKS in csrc/resblock.cu).
FUSED_PLAN = {16: ("stage", 512), 32: ("stage", 232), 64: ("stage", 224),
              128: ("pair", 240)}
FUSED_BLOCKS_PER_SM = {16: 2, 32: 2, 64: 1, 128: 1}


def _convs_per_launch(mode: str, n_rb: int, n_dil: int) -> int:
    return {"stage": 2 * n_dil * n_rb, "chain": 2 * n_dil, "pair": 2}[mode]


def fused_rows(bm: int, length: int, batch: int, slots: int) -> int:
    """Output rows per block for a launch of ``batch`` x ``length`` rows on
    ``slots`` resident blocks (SMs x blocks per SM): as many waves as
    ``bm`` rows a block would take, with the rows spread evenly over them
    (a multiple of 8, at least 64, below which the halo is most of the
    work), so that the last wave is not a sliver."""
    blocks = batch * -(-length // bm)
    waves = -(-blocks // slots)
    per_utterance = max(1, waves * slots // batch)
    rows = -(-length // per_utterance)
    return min(bm, max(64, -(-rows // 8) * 8))


def resblock_group_bf16_tiled(x, rb_weights, kernel_sizes, dilations,
                              plan=None, fault=None):
    """``resblock_group_bf16``'s function computed as its kernel tiles it,
    in plain PyTorch: per launch of the plan (``plan`` = (convs per launch,
    rows per block); unless given, ``FUSED_PLAN[C]`` with the rows
    ``fused_rows`` gives on 132 SMs), per block of ``bm`` output rows of one
    utterance and per run of
    convs inside one chain, the frame of ``bm`` rows plus the run's halo
    (the sum of its convs' (k - 1) d) is read with zeros outside [0, L); each
    conv computes the rows the later convs need and writes rows outside
    [0, L) as zeros before the next conv reads them; z stays f32 in the
    frame and passes between launches in f32, and the running sum over
    chains in an f32 buffer that each chain's last conv adds to. ``fault=
    "halo"`` skips that zeroing after each conv (the planted error the tests
    show the tolerance catches). x (B, L, C) bf16 -> (B, L, C) bf16."""
    if isinstance(rb_weights, PackedResblocks):
        rb_weights = rb_weights.torch_weights
    batch, length, c = x.shape
    if plan is None:
        mode, bm = FUSED_PLAN[c]
        plan = mode, fused_rows(bm, length, batch, 132 * FUSED_BLOCKS_PER_SM[c])
    mode, bm = plan
    convs = []
    for k, dils, rbw in zip(kernel_sizes, dilations, rb_weights):
        for i, (w, b) in enumerate(rbw):
            convs.append((_bf16_round(w), b.float(), k,
                          1 if i % 2 else dils[i // 2]))
    per_chain, n_rb = 2 * len(dilations[0]), len(rb_weights)
    per_launch = _convs_per_launch(mode, n_rb, len(dilations[0]))
    xf = x.float()
    acc = torch.zeros_like(xf)
    z_buf = [torch.zeros_like(xf), torch.zeros_like(xf)]
    out = torch.empty_like(x)

    def pad(cc):
        return (convs[cc][2] - 1) * convs[cc][3] // 2

    def plane(v, keep):  # a conv's input: leaky, bf16, zeros outside [0, L)
        v = _bf16_round(F.leaky_relu(v, LRELU_SLOPE))
        return v if fault == "halo" else v * keep[:, None]

    for c0 in range(0, len(convs), per_launch):
        for b in range(batch):
            for t0 in range(0, length, bm):
                c = c0
                while c < c0 + per_launch:
                    chain = c // per_chain
                    run_end = min(c0 + per_launch, (chain + 1) * per_chain)
                    half = sum(pad(cc) for cc in range(c, run_end))
                    rows = bm + 2 * half
                    lo = t0 - half
                    idx = torch.arange(lo, lo + rows)
                    keep = ((idx >= 0) & (idx < length)).float()
                    local = c - chain * per_chain
                    z_src = xf if local < 2 else z_buf[(local // 2 - 1) % 2]

                    def gather(src):
                        return src[b, idx.clamp(0, length - 1)] * keep[:, None]

                    z = gather(z_src)
                    a = plane(z, keep)
                    cum = 0
                    for cc in range(c, run_end):
                        w, bias, k, d = convs[cc]
                        p = pad(cc)
                        cum += p
                        seg = a[cum - p:rows - cum + p].t()[None]
                        y = F.conv1d(seg, w, bias, dilation=d)[0].t()
                        span = slice(cum, rows - cum)
                        own = slice(t0, min(t0 + bm, length))
                        n_own = own.stop - own.start
                        second = (cc - chain * per_chain) % 2
                        last = cc == run_end - 1
                        if second:
                            y = y + z[span]
                            if cc == (chain + 1) * per_chain - 1:
                                y = y[:n_own]
                                if chain > 0:
                                    y = y + acc[b, own]
                                if chain == n_rb - 1:
                                    out[b, own] = (y / float(n_rb)).to(x.dtype)
                                else:
                                    acc[b, own] = y
                            elif last:
                                z_buf[(cc - chain * per_chain) // 2 % 2][b, own] = y[:n_own]
                            else:
                                z[span] = y
                                a[span] = plane(y, keep[span])
                        else:
                            a[span] = plane(y, keep[span])
                    c = run_end
    return out


# ---------------------------------------------------------------- packing


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """Torch Conv1d weight (C_out, C_in, k) -> the kernel's split B tiles,
    (2, k, C_in / 8, C_out / 8, 2, 8, 4): plane 0 holds tf32 hi, plane 1 tf32
    lo (``tf32_split``); for each tap and block of eight input channels, each
    group of eight output channels is two 8 x 4 core matrices (rows: output
    channels, words: four input channels), the K-major layout that the
    kernel's wgmma descriptor names, contiguous so that it copies in
    16-byte runs."""
    c_out, c_in, k = w.shape

    def tiles(v):  # v[co, ci, tau], co = 8 ng + r, ci = 8 chunk + 4 kg + kk
        v = v.reshape(c_out // 8, 8, c_in // 8, 2, 4, k)
        return v.permute(5, 2, 0, 3, 1, 4)

    return torch.stack([tiles(p) for p in tf32_split(w.detach())]).contiguous()


def unpack_conv_weight(wp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``pack_conv_weight``'s planes back in the torch layout: (hi, lo), each
    (C_out, C_in, k)."""
    _, k, n_ci, n_co = wp.shape[:4]
    return tuple(p.permute(2, 4, 1, 3, 5, 0).reshape(8 * n_co, 8 * n_ci, k)
                 for p in wp)


def pack_conv_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """Torch Conv1d weight (C_out, C_in, k) -> the bf16 kernel's B tiles,
    (k, C_in / 16, C_out / 8, 2, 8, 8) bf16: for each tap and block of
    sixteen input channels, each group of eight output channels is two 8 x 8
    core matrices (rows: output channels, 16 bytes: eight input channels),
    the K-major layout of a wgmma k16 step."""
    c_out, c_in, k = w.shape
    v = w.detach().to(torch.bfloat16).reshape(c_out // 8, 8, c_in // 16, 2, 8, k)
    return v.permute(5, 2, 0, 3, 1, 4).contiguous()


def unpack_conv_weight_bf16(wp: torch.Tensor) -> torch.Tensor:
    """``pack_conv_weight_bf16``'s tiles back in the torch layout."""
    k, n_ci, n_co = wp.shape[:3]
    return wp.permute(2, 4, 1, 3, 5, 0).reshape(8 * n_co, 16 * n_ci, k)


class PackedResblocks:
    """A stage's resblock weights packed for the kernel, with the torch
    layout kept (by reference) for the plain version and the checks. The
    packing is made on first use of ``packed``, which only the kernel path
    reads, so the CPU path never packs (and takes any channel count)."""

    def __init__(self, rb_weights):
        self.torch_weights = [list(rbw) for rbw in rb_weights]
        self._packed = None
        self._packed_bf16 = None

    @property
    def packed(self):
        """Split-TF32 tiles for the f32 kernel (made on first use)."""
        if self._packed is None:
            with torch.no_grad():
                self._packed = [[(pack_conv_weight(w), b.detach().contiguous())
                                 for w, b in rbw] for rbw in self.torch_weights]
        return self._packed

    @property
    def packed_bf16(self):
        """bf16 tiles for the bf16 kernel (made on first use); the bias
        stays f32."""
        if self._packed_bf16 is None:
            with torch.no_grad():
                self._packed_bf16 = [
                    [(pack_conv_weight_bf16(w), b.detach().float().contiguous())
                     for w, b in rbw] for rbw in self.torch_weights]
        return self._packed_bf16


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x`` as the kernels split it: hi = tf32(x),
    lo = tf32(x - hi), each rounded to the nearest TF32 value (10-bit
    mantissa) with ties away from zero, bit for bit as ``cvt.rna.tf32.f32``
    (finite inputs)."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def conv_packed_plain(x, wp, b, dilation, products="3xtf32"):
    """One 'same' conv as the kernel computes it, from packed weights, with
    the sums in float64: out[t] = b + sum_tau x[t + tau * d - pad] . W_tau
    with zero rows outside [0, L), where every product is taken from the
    split operands as the tensor cores take it: lo*hi + hi*lo + hi*hi
    ("3xtf32"), or hi*hi alone ("tf32"). x (B, L, C_in), wp from
    ``pack_conv_weight`` -> (B, L, C_out)."""
    if products not in ("3xtf32", "tf32"):
        raise ValueError(f"products: '3xtf32' or 'tf32', got {products!r}")
    w_hi, w_lo = (v.double() for v in unpack_conv_weight(wp))
    k = w_hi.shape[-1]
    pad = (k - 1) * dilation // 2
    x_hi, x_lo = (v.double() for v in tf32_split(F.pad(x, (0, 0, pad, pad))))
    pairs = [(x_hi, w_hi)]
    if products == "3xtf32":
        pairs = [(x_lo, w_hi), (x_hi, w_lo)] + pairs
    length = x.shape[1]
    out = b.double().expand(x.shape[0], length, -1).clone()
    for xa, wa in pairs:
        for tau in range(k):
            s = tau * dilation
            out += xa[:, s:s + length] @ wa[:, :, tau].t()
    return out


# ---------------------------------------------------------------- kernel


def _check_weights(rb_weights, kernel_sizes, dilations, c, device,
                   bf16: bool = False):
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
        shape = ((k, c // 16, c // 8, 2, 8, 8) if bf16
                 else (2, k, c // 8, c // 8, 2, 8, 4))
        for w, b in rbw:
            kernels.check_cuda_input(w, "resblock weight", len(shape),
                                     torch.bfloat16 if bf16 else torch.float32)
            kernels.check_cuda_input(b, "resblock bias", 1)
            if tuple(w.shape) != shape or tuple(b.shape) != (c,):
                raise ValueError(f"resblock_group: packed weight "
                                 f"{tuple(w.shape)} / bias {tuple(b.shape)} "
                                 f"for C={c}, k={k}")
            if w.device != device:
                raise ValueError("resblock_group: weights on another device")


def _nest(flat, dilations) -> list:
    """Flat (w, b, w, b, ...) in chain order -> one [(w, b), ...] list per
    resblock (two convs per dilation)."""
    pairs = list(zip(flat[0::2], flat[1::2]))
    out, i = [], 0
    for dils in dilations:
        out.append(pairs[i:i + 2 * len(dils)])
        i += 2 * len(dils)
    return out


def _group_backward(ctx, grad_out, plain):
    ks, ds = ctx.kernel_sizes, ctx.dilations
    grads = kernels.plain_backward(
        lambda x, *flat: plain(x, _nest(flat, ds), ks, ds), ctx.saved_tensors,
        (ctx.needs_input_grad[1],) + ctx.needs_input_grad[5:], grad_out)
    return (None, grads[0], None, None, None) + grads[1:]


class ResblockGroupFunction(torch.autograd.Function):
    """``impl(x, packed, kernel_sizes, dilations)`` forward (the kernel; the
    plain version in the CPU tests), backward through
    ``resblock_group_plain``. ``weights``: the torch-layout (w, b) tensors
    flat in chain order, those ``packed`` was made from."""

    @staticmethod
    def forward(ctx, impl, x, packed, kernel_sizes, dilations, *weights):
        ctx.kernel_sizes, ctx.dilations = kernel_sizes, dilations
        ctx.save_for_backward(x, *weights)
        return impl(x, packed, kernel_sizes, dilations)

    @staticmethod
    def backward(ctx, grad_out):
        return _group_backward(ctx, grad_out, resblock_group_plain)


class ResblockGroupBf16Function(ResblockGroupFunction):
    """The same for K2's bf16 class: the backward runs autograd through
    ``resblock_group_bf16_plain`` (bf16 x in, bf16 gradient of x out)."""

    @staticmethod
    def backward(ctx, grad_out):
        return _group_backward(ctx, grad_out, resblock_group_bf16_plain)


def resblock_group(x, rb_weights, kernel_sizes, dilations):
    """x (B, L, C) -> mean over the stage's ResBlock1 chains, (B, L, C).

    ``rb_weights``: the nested torch-layout list, or its
    ``PackedResblocks``. A float32 x takes this kernel, a bfloat16 x K2's
    bf16 class (``resblock_group_bf16``); another dtype raises. A CPU tensor
    takes the plain version; a CUDA tensor (C a multiple of 16) launches 18
    conv kernels (one stage) and counts one launch in
    ``resblock_group.launches``. With grad on and x or a weight requiring
    it, the launch goes through ``ResblockGroupFunction``.
    """
    if x.dtype == torch.bfloat16:
        return resblock_group_bf16(x, rb_weights, kernel_sizes, dilations)
    if x.dtype != torch.float32:
        raise ValueError(f"resblock_group: float32 or bfloat16 x, got {x.dtype}")
    if x.device.type == "cpu":
        return resblock_group_plain(x, rb_weights, kernel_sizes, dilations)
    if not isinstance(rb_weights, PackedResblocks):
        rb_weights = PackedResblocks(rb_weights)
    flat = [t for rbw in rb_weights.torch_weights for wb in rbw for t in wb]
    if kernels.grad_wanted(x, *flat):
        return ResblockGroupFunction.apply(_launch, x, rb_weights, kernel_sizes,
                                           dilations, *flat)
    return _launch(x, rb_weights, kernel_sizes, dilations)


def _launch(x, rb_weights: PackedResblocks, kernel_sizes, dilations):
    kernels.check_cuda_input(x, "resblock_group x", 3)
    b, length, c = x.shape
    if c % 16 != 0:
        raise ValueError(f"resblock_group: channels a multiple of 16, got {c}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("resblock_group: x must be 16-byte aligned")
    packed = rb_weights.packed
    _check_weights(packed, kernel_sizes, dilations, c, x.device)
    flat = [wb for rbw in packed for wb in rbw]
    w_ptrs = (ctypes.c_void_p * len(flat))(*(w.data_ptr() for w, _ in flat))
    b_ptrs = (ctypes.c_void_p * len(flat))(*(bb.data_ptr() for _, bb in flat))
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds_flat = [d for dils in dilations for d in dils]
    ds = (ctypes.c_int * len(ds_flat))(*ds_flat)
    out, t_buf, z_buf, s_buf = (torch.empty_like(x) for _ in range(4))
    kernels.launch(
        "resblock_group", "ddsp_resblock_group", x.device,
        x.data_ptr(), w_ptrs, b_ptrs, ks, ds, len(kernel_sizes),
        len(dilations[0]), out.data_ptr(), t_buf.data_ptr(), z_buf.data_ptr(),
        s_buf.data_ptr(), b, length, c)
    kernels.count_launch(resblock_group)
    return out


resblock_group.launches = 0


def resblock_group_bf16(x, rb_weights, kernel_sizes, dilations):
    """K2's bf16 class: x (B, L, C) bf16 -> the stage's resblock mean,
    (B, L, C) bf16 (see ``resblock_group_bf16_plain``). A CPU tensor takes
    the plain version; a CUDA tensor (C = 16, 32, 64 or 128) launches the
    fused bf16 kernel (one launch a stage at C <= 64, one per conv pair at
    C = 128: ``FUSED_PLAN``) and counts one launch in
    ``resblock_group_bf16.launches``. With grad on
    and x or a weight requiring it, the launch goes through
    ``ResblockGroupBf16Function``."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"resblock_group_bf16: bfloat16 x, got {x.dtype}")
    if x.device.type == "cpu":
        return resblock_group_bf16_plain(x, rb_weights, kernel_sizes, dilations)
    if not isinstance(rb_weights, PackedResblocks):
        rb_weights = PackedResblocks(rb_weights)
    flat = [t for rbw in rb_weights.torch_weights for wb in rbw for t in wb]
    if kernels.grad_wanted(x, *flat):
        return ResblockGroupBf16Function.apply(
            _launch_bf16, x, rb_weights, kernel_sizes, dilations, *flat)
    return _launch_bf16(x, rb_weights, kernel_sizes, dilations)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_bf16(x, rb_weights: PackedResblocks, kernel_sizes, dilations):
    kernels.check_cuda_input(x, "resblock_group_bf16 x", 3, torch.bfloat16)
    b, length, c = x.shape
    if c not in FUSED_PLAN:
        raise ValueError(f"resblock_group_bf16: channels 16, 32, 64 or 128, "
                         f"got {c}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("resblock_group_bf16: x must be 16-byte aligned")
    packed = rb_weights.packed_bf16
    _check_weights(packed, kernel_sizes, dilations, c, x.device, bf16=True)
    flat = [wb for rbw in packed for wb in rbw]
    w_ptrs = (ctypes.c_void_p * len(flat))(*(w.data_ptr() for w, _ in flat))
    b_ptrs = (ctypes.c_void_p * len(flat))(*(bb.data_ptr() for _, bb in flat))
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    ds_flat = [d for dils in dilations for d in dils]
    ds = (ctypes.c_int * len(ds_flat))(*ds_flat)
    mode, bm = FUSED_PLAN[c]
    bm = fused_rows(bm, length, b, _sm_count(x.device) * FUSED_BLOCKS_PER_SM[c])
    per_launch = _convs_per_launch(mode, len(kernel_sizes), len(dilations[0]))
    out = torch.empty_like(x)

    def scratch(n):  # f32 scratch of n times x's size (or none)
        return torch.empty((n,) + tuple(x.shape), dtype=torch.float32,
                           device=x.device)

    acc = scratch(1)
    z_buf = scratch(2 if mode == "pair" else 0)
    kernels.launch(
        "resblock_group_bf16", "ddsp_resblock_group_bf16", x.device,
        x.data_ptr(), w_ptrs, b_ptrs, ks, ds, len(kernel_sizes),
        len(dilations[0]), out.data_ptr(), acc.data_ptr(), z_buf.data_ptr(),
        b, length, c, per_launch, bm)
    kernels.count_launch(resblock_group_bf16)
    return out


resblock_group_bf16.launches = 0
