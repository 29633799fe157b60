"""The split-TF32 precision scheme of K2 and K3 and K2's weight packing, on
the CPU. The kernels multiply on the tensor cores as lo*hi + hi*lo + hi*hi
of operands split by ``cvt.rna.tf32.f32``; ``tf32_split`` and
``conv_packed_plain`` are that arithmetic in plain PyTorch."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.nsf_hifigan import Generator
from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                  conv_packed_plain,
                                                  pack_conv_weight,
                                                  resblock_group,
                                                  resblock_group_plain,
                                                  tf32_split,
                                                  unpack_conv_weight)
import torch_helpers  # noqa: F401,E402  (torch's threads under xdist)

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10-bit mantissa), nearest, ties away from
    zero, by comparing the two neighbouring TF32 values in float64."""
    bits = x.astype(np.float32).view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32)
    up = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32)
    xd, dd, ud = (v.astype(np.float64) for v in (x, down, up))
    return np.where(np.abs(ud - xd) <= np.abs(xd - dd), up, down)


def test_tf32_split_is_cvt_rna_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(20000) * np.exp(rng.uniform(-20, 20, 20000)),
        # exact ties (the 13 dropped bits are 1000...0) and their neighbours
        (np.arange(1, 200, dtype=np.uint32) << 13 | 0x1000).view(np.float32),
        -(np.arange(1, 200, dtype=np.uint32) << 13 | 0x1000).view(np.float32),
        np.float32([0.0, -0.0, 1.0, -1.0, 3.4e38, 1e-45, 1.1754942e-38]),
    ]).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x))
    want_hi = _rna_reference(x)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    want_lo = _rna_reference((x.astype(np.float64) - want_hi).astype(np.float32))
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    # hi + lo carries ~21 bits of a normal x: within 2^-21 relative of it
    normal = (np.abs(x) < 1e38) & (np.abs(x) > 1e-30)
    err = np.abs((hi.double() + lo.double()).numpy() - x.astype(np.float64))
    assert (err[normal] <= 2.0 ** -21 * np.abs(x[normal])).all()


def _stage_slice(seed, c=128, length=300, k=11):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, length, c)).astype(np.float32))
    bound = 1.0 / np.sqrt(c * k)
    w = torch.from_numpy(rng.uniform(-bound, bound, (c, c, k)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-bound, bound, (c,)).astype(np.float32))
    return F.leaky_relu(x, 0.1), w, b


def _conv1d_f64(x, w, b, d):
    k = w.shape[-1]
    return F.conv1d(x.transpose(1, 2).double(), w.double(), b.double(),
                    padding=(k - 1) * d // 2, dilation=d).transpose(1, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_products_keep_f32_accuracy(seed):
    """One C = 128, k = 11, d = 5 conv of a stage slice from split operands
    (3 products, float64 sums) stays within 1e-6 x max|out| of the float64
    conv: the dropped lo*lo term and lo's rounding are ~2^-22 a product."""
    x, w, b = _stage_slice(seed)
    exact = _conv1d_f64(x, w, b, 5)
    split = conv_packed_plain(x, pack_conv_weight(w), b, 5)
    assert float((split - exact).abs().max() / exact.abs().max()) <= 1e-6


def test_one_tf32_product_misses_the_kernel_tolerance():
    """One TF32 pass (hi*hi) lands near 1e-3 x max|out|: it cannot meet the
    1e-4 the kernels are held to, hence three products."""
    x, w, b = _stage_slice(2)
    exact = _conv1d_f64(x, w, b, 5)
    one = conv_packed_plain(x, pack_conv_weight(w), b, 5, products="tf32")
    assert float((one - exact).abs().max() / exact.abs().max()) > 1e-4


@pytest.mark.parametrize("c,k,d,length", [(16, 3, 1, 40), (32, 7, 3, 57),
                                          (64, 11, 5, 23), (48, 5, 2, 9)])
def test_packed_weights_give_back_conv1d(c, k, d, length):
    """The packed planes are the weight's TF32 split in the wgmma tile
    layout: element (co, ci, tau) sits at [tau, ci // 8, co // 8,
    ci % 8 // 4, co % 8, ci % 4]; unpacked, hi + lo is the weight to 2^-21,
    and the conv summed tap by tap over shifted rows with zeros outside the
    utterance is F.conv1d's 'same' conv (the shortest length is below the
    halo)."""
    rng = np.random.default_rng(c + k)
    x = torch.from_numpy(rng.standard_normal((2, length, c)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((c, c, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((c,)).astype(np.float32))
    wp = pack_conv_weight(w)
    assert wp.shape == (2, k, c // 8, c // 8, 2, 8, 4) and wp.is_contiguous()
    hi, lo = tf32_split(w)
    co, ci, tau = c - 3, c // 2 + 5, k - 1
    at = (tau, ci // 8, co // 8, ci % 8 // 4, co % 8, ci % 4)
    assert wp[0][at] == hi[co, ci, tau] and wp[1][at] == lo[co, ci, tau]
    got_hi, got_lo = unpack_conv_weight(wp)
    assert torch.equal(got_hi, hi) and torch.equal(got_lo, lo)
    err = (got_hi.double() + got_lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -21 * w.double().abs()).all())
    want = _conv1d_f64(x, w, b, d)
    got = conv_packed_plain(x, wp, b, d)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def _torch_rb_weights(rng, c):
    out = []
    for k, dils in zip(KS, DS):
        bound = 1.0 / np.sqrt(c * k)
        out.append([(torch.from_numpy(rng.uniform(-bound, bound, (c, c, k)).astype(np.float32)),
                     torch.from_numpy(rng.uniform(-bound, bound, (c,)).astype(np.float32)))
                    for _ in range(2 * len(dils))])
    return out


def test_packed_stage_takes_the_plain_path_on_the_cpu():
    """A ``PackedResblocks`` keeps the torch layout by reference: on CPU
    tensors the wrapper gives what the nested list gives, and launches
    nothing."""
    rng = np.random.default_rng(3)
    tw = _torch_rb_weights(rng, 16)
    packed = PackedResblocks(tw)
    assert packed.torch_weights[1][2][0] is tw[1][2][0]
    assert [wp.shape for wp, _ in packed.packed[2]] == [(2, 11, 2, 2, 2, 8, 4)] * 6
    x = torch.from_numpy(rng.standard_normal((2, 50, 16)).astype(np.float32))
    resblock_group.launches = 0
    assert torch.equal(resblock_group(x, packed, KS, DS),
                       resblock_group_plain(x, tw, KS, DS))
    assert resblock_group.launches == 0


def test_cpu_path_packs_nothing_and_takes_any_width():
    """The kernel needs C a multiple of 16, the plain path does not: a
    ``PackedResblocks`` of a C = 12 stage serves the CPU path without ever
    being packed."""
    rng = np.random.default_rng(4)
    tw = _torch_rb_weights(rng, 12)
    packed = PackedResblocks(tw)
    x = torch.from_numpy(rng.standard_normal((1, 30, 12)).astype(np.float32))
    assert torch.equal(resblock_group(x, packed, KS, DS),
                       resblock_group_plain(x, tw, KS, DS))
    with pytest.raises(RuntimeError):  # C = 12 has no 8 x 8 tiles
        _ = packed.packed


def test_generator_packs_each_stage_once_per_model():
    """The serving path packs K2's weights once: the same object on every
    later call, a new one only when a weight changes (in place, or on a new
    tensor)."""
    gen = random_init_(Generator(44100, num_mels=8, upsample_rates=(2, 2),
                                 upsample_kernel_sizes=(4, 4),
                                 upsample_initial_channel=64),
                       torch.Generator().manual_seed(0))
    first = [gen.stage_weights(i) for i in range(2)]
    assert all(isinstance(p, PackedResblocks) for p in first)
    assert [gen.stage_weights(i) for i in range(2)] == first
    w = gen.resblocks[0].convs1[0].weight
    assert torch.equal(first[0].packed[0][0][0], pack_conv_weight(w))
    with torch.no_grad():
        w.mul_(2.0)
    again = gen.stage_weights(0)
    assert again is not first[0]
    assert torch.equal(again.packed[0][0][0], pack_conv_weight(w))
    assert gen.stage_weights(1) is first[1]
    gen.resblocks[3].convs2[2].weight = torch.nn.Parameter(
        gen.resblocks[3].convs2[2].weight.detach().clone())
    second = gen.stage_weights(1)
    assert second is not first[1]
    gen.resblocks[4].convs1[1].bias = torch.nn.Parameter(
        gen.resblocks[4].convs1[1].bias.detach() + 1.0)
    third = gen.stage_weights(1)
    assert third is not second
    assert torch.equal(third.packed[1][2][1], gen.resblocks[4].convs1[1].bias.detach())
