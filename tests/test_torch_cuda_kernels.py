"""The port's CUDA kernels against their plain versions on the card
(run on a machine with one: ``python -m pytest tests/test_torch_cuda_kernels.py
-m cuda -n 0``). Whether a card exists is decided inside the fixture, so
every worker collects the same tests; here they skip without one.

TF32 is off for the plain versions. Tolerances: K1 5e-5 absolute on the
samples and 1e-6 rad on ``phase_frames``; K2 and K3 1e-4 relative to
max|out|, since sums run in another order; K2's and K3's bf16 classes
their ``bf16_agreement`` / ``bf16_layer_agreement``; K4 3e-5 absolute."""
import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _vibrato_f0(b, t, device):
    """220 Hz (x 1.5 per further row) with 5.5 Hz vibrato and an unvoiced
    stretch: (B, T, 1)."""
    time_s = np.arange(t) * 512 / 44100
    f0 = 220.0 * 2.0 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * time_s))
    f0 = np.stack([f0 * (1.0 + 0.5 * i) for i in range(b)])
    f0[:, t // 3: t // 2] = 0.0
    return torch.tensor(f0, dtype=torch.float32, device=device)[..., None]


@pytest.mark.parametrize("t", [5, 173, 862, (1 << 13) + 5])
@pytest.mark.parametrize("b,offset", [(1, False), (2, False), (2, True)])
def test_combtooth_kernel(cuda, b, t, offset):
    """K1 against its plain version: samples within 5e-5, ``phase_frames``
    within 1e-6 rad (one carry quantum is 2 pi 2^-22 ~ 1.5e-6 rad, so a
    wrong carry fails), with a ``carry_offset_q`` (int64, one negative and
    one past 2^32) or without; 2^13 + 5 frames span many of the scan's
    blocks."""
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth, combtooth_plain

    f0 = _vibrato_f0(b, t, cuda)
    off = (torch.tensor([-123456789, (1 << 34) + 98765][:b], dtype=torch.int64,
                        device=cuda).reshape(b, 1, 1) if offset else None)
    n0 = combtooth.launches
    got, got_phase = combtooth(f0, 44100, 512, off)
    want, want_phase = combtooth_plain(f0, 44100, 512, off)
    torch.cuda.synchronize()
    assert combtooth.launches == n0 + 1
    assert got.shape == want.shape and got_phase.shape == want_phase.shape
    assert float((got - want).abs().max()) <= 5e-5
    assert float((got_phase - want_phase).abs().max()) <= 1e-6
    if offset:  # an int32 offset with the same low bits gives the same
        got32, phase32 = combtooth(f0, 44100, 512, off.to(torch.int32))
        assert torch.equal(got32, got) and torch.equal(phase32, got_phase)


def test_combtooth_kernel_unvoiced(cuda):
    """All frames unvoiced (f0 = 0): every sample is sinc(0) = 1."""
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth, combtooth_plain

    f0 = torch.zeros((2, 173, 1), device=cuda)
    got, got_phase = combtooth(f0, 44100, 512)
    want, want_phase = combtooth_plain(f0, 44100, 512)
    assert float((got - want).abs().max()) <= 5e-5
    assert float((got_phase - want_phase).abs().max()) <= 1e-6


@pytest.mark.parametrize("block", [480, 441])
def test_combtooth_kernel_other_blocks(cuda, block):
    """A block size that is no power of two divides where 512 multiplies
    by its reciprocal."""
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth, combtooth_plain

    f0 = _vibrato_f0(2, 173, cuda)
    got, got_phase = combtooth(f0, 44100, block)
    want, want_phase = combtooth_plain(f0, 44100, block)
    assert float((got - want).abs().max()) <= 5e-5
    assert float((got_phase - want_phase).abs().max()) <= 1e-6


def test_combtooth_call_is_two_device_ops(cuda):
    """A combtooth() call puts at most two operations on the device (the
    scan's scratch memset and the kernel) and copies nothing from the
    host."""
    from torch.profiler import ProfilerActivity, profile

    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth

    f0 = _vibrato_f0(1, 862, cuda)
    combtooth(f0, 44100, 512)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        combtooth(f0, 44100, 512)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(device) <= 2, [e.name for e in device]
    assert not any("HtoD" in e.name for e in device)
    assert any("combtooth_kernel" in e.name for e in device)


@pytest.mark.parametrize("c,length,packed", [
    (16, 1000, False), (32, 513, True), (64, 777, False), (128, 129, True),
    (256, 300, False),
    # shorter than one time tile (128 rows at C >= 64, 256 below) and than
    # the chain's 60-row halo a side
    (16, 7, True), (64, 45, False), (256, 50, True),
    # no multiple of the tile, a few tiles long
    (128, 1001, False)])
def test_resblock_group_kernel(cuda, c, length, packed):
    """All five stage widths at B = 2, with weights packed once
    (``PackedResblocks``) or packed by the wrapper on the call."""
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                      resblock_group,
                                                      resblock_group_plain)

    gen = torch.Generator().manual_seed(c + length)
    x = torch.randn((2, length, c), generator=gen).to(cuda)
    weights = []
    for k, dils in zip(KS, DS):
        b = 1 / math.sqrt(c * k)
        weights.append([(((torch.rand((c, c, k), generator=gen) * 2 - 1) * b).to(cuda),
                         ((torch.rand((c,), generator=gen) * 2 - 1) * b).to(cuda))
                        for _ in range(2 * len(dils))])
    arg = PackedResblocks(weights) if packed else weights
    n0 = resblock_group.launches
    got = resblock_group(x, arg, KS, DS)
    torch.cuda.synchronize()
    assert resblock_group.launches == n0 + 1
    want = resblock_group_plain(x, weights, KS, DS)
    assert _rel(got, want) <= 1e-4
    # a row of the batch computed alone is the same row in the batch
    one = resblock_group(x[1:].contiguous(), arg, KS, DS)
    assert torch.equal(one[0], got[1])


@pytest.mark.parametrize("c,length", [(128, 1001), (64, 45), (32, 3000),
                                      (16, 7), (16, 27_585)])
@pytest.mark.parametrize("b", [1, 2])
def test_resblock_group_bf16_kernel(cuda, b, c, length):
    """K2's bf16 class at the four widths it serves, ragged lengths, B = 1
    and 2, within ``bf16_agreement``'s tolerance of its plain version: bf16
    out, one launch in its own counter (none in K2's f32 counter), and a
    row computed alone equals the same row of the batch."""
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                      bf16_agreement,
                                                      resblock_group,
                                                      resblock_group_bf16,
                                                      resblock_group_bf16_plain)

    gen = torch.Generator().manual_seed(c + length + b)
    x = torch.randn((b, length, c), generator=gen).to(cuda).to(torch.bfloat16)
    weights = []
    for k, dils in zip(KS, DS):
        bd = 1 / math.sqrt(c * k)
        weights.append([(((torch.rand((c, c, k), generator=gen) * 2 - 1) * bd).to(cuda),
                         ((torch.rand((c,), generator=gen) * 2 - 1) * bd).to(cuda))
                        for _ in range(2 * len(dils))])
    packed = PackedResblocks(weights)
    n0, f0 = resblock_group_bf16.launches, resblock_group.launches
    got = resblock_group(x, packed, KS, DS)
    torch.cuda.synchronize()
    assert (resblock_group_bf16.launches, resblock_group.launches) == (n0 + 1, f0)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = resblock_group_bf16_plain(x, weights, KS, DS)
    agree = bf16_agreement(got, want)
    assert agree["ok"], agree
    one = resblock_group_bf16(x[-1:].contiguous(), packed, KS, DS)
    assert torch.equal(one[0], got[-1])


# samples per frame at each bf16 stage of the default generator
PER_FRAME = {128: 64, 64: 128, 32: 256, 16: 512}


@pytest.mark.parametrize("b,length", [(2, 1), (2, 50), (2, 333), (8, None)])
@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_resblock_group_bf16_fused_edges(cuda, c, b, length):
    """The fused kernel where its tiling is most fragile: one row, L below
    the k = 11 chain's 60-row halo a side, ragged rows at B = 2, and the
    B = 8 x 1024-frame bucket (``length`` None); within ``bf16_agreement``
    of the plain version, exactly one launch counted, and every row alone
    equal to the same row of the batch."""
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                      bf16_agreement,
                                                      resblock_group_bf16,
                                                      resblock_group_bf16_plain)

    length = length or 1024 * PER_FRAME[c]
    gen = torch.Generator().manual_seed(7 * c + b + length)
    x = torch.randn((b, length, c), generator=gen).to(cuda).to(torch.bfloat16)
    weights = []
    for k, dils in zip(KS, DS):
        bd = 1 / math.sqrt(c * k)
        weights.append([(((torch.rand((c, c, k), generator=gen) * 2 - 1) * bd).to(cuda),
                         ((torch.rand((c,), generator=gen) * 2 - 1) * bd).to(cuda))
                        for _ in range(2 * len(dils))])
    packed = PackedResblocks(weights)
    n0 = resblock_group_bf16.launches
    got = resblock_group_bf16(x, packed, KS, DS)
    torch.cuda.synchronize()
    assert resblock_group_bf16.launches == n0 + 1
    agree = bf16_agreement(got, resblock_group_bf16_plain(x, weights, KS, DS))
    assert agree["ok"], agree
    for row in (0, b - 1):
        assert torch.equal(resblock_group_bf16(x[row:row + 1].contiguous(), packed,
                                               KS, DS)[0], got[row])


def test_bf16_generator_never_reaches_the_plain_version(cuda, monkeypatch):
    """A bf16 generator on the card runs K2-bf16 at C = 128 ... 16 (four
    launches) and the stock chain at C = 256; the plain version, patched to
    raise on a CUDA tensor, is never reached."""
    from ddsp_svc_tpu_torch.models import nsf_hifigan
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.ops import cuda_resblock

    def refuse(x, *args):
        if x.is_cuda:
            raise AssertionError("resblock_group_bf16_plain on a CUDA tensor")
        return plain(x, *args)

    plain = cuda_resblock.resblock_group_bf16_plain
    monkeypatch.setattr(cuda_resblock, "resblock_group_bf16_plain", refuse)
    gen = nsf_hifigan.Generator(44100)
    random_init_(gen, torch.Generator().manual_seed(3))
    gen = gen.to(cuda).eval()
    mel = torch.randn((1, 20, 128), generator=torch.Generator().manual_seed(4)).to(cuda)
    f0 = torch.full((1, 20), 220.0, device=cuda)
    n0, f0_n = cuda_resblock.resblock_group_bf16.launches, cuda_resblock.resblock_group.launches
    with torch.no_grad():
        out = gen(mel, f0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert cuda_resblock.resblock_group_bf16.launches == n0 + 4
    assert cuda_resblock.resblock_group.launches == f0_n


@pytest.mark.parametrize("b,t,c,hc,k", [(1, 862, 512, 128, 31), (2, 37, 64, 32, 7),
                                        (2, 37, 512, 128, 31),
                                        (3, 300, 512, 128, 31)])
def test_conformer_layer_kernel(cuda, b, t, c, hc, k):
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (conformer_layer,
                                                       conformer_layer_plain)

    gen = torch.Generator().manual_seed(t)
    inner = 2 * c

    def r(*shape, scale):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(cuda)

    x, cond, step = r(b, t, c, scale=1.0), r(b, t, hc, scale=1.0), r(b, c, scale=1.0)
    w = (r(c, hc, scale=hc ** -0.5), r(c, scale=0.1), r(2 * inner, c, scale=c ** -0.5),
         r(2 * inner, scale=0.1), r(inner, k, scale=k ** -0.5), r(inner, scale=0.1),
         r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
    n0 = conformer_layer.launches
    got = conformer_layer(x, cond, step, w)
    torch.cuda.synchronize()
    assert conformer_layer.launches == n0 + 1
    want = conformer_layer_plain(x, cond, step, w)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("b,t,c,hc,k", [(1, 862, 512, 128, 31), (48, 172, 512, 128, 31),
                                        (1, 37, 64, 32, 7), (2, 101, 128, 16, 31),
                                        (1, 1, 512, 128, 31), (1, 15, 512, 128, 31),
                                        (1, 16, 512, 128, 31), (3, 15, 512, 128, 31),
                                        (64, 65, 512, 128, 31), (1, 4100, 200, 64, 31),
                                        (5, 1000, 256, 64, 3), (274, 15, 128, 16, 31)])
def test_conformer_layer_bf16_kernel(cuda, b, t, c, hc, k):
    """B3 against its plain version within ``bf16_layer_agreement`` (other
    f32 sum orders flip bf16 roundings of h and s), at the 10 s and the
    training shapes, at B = 1, 2 with ragged T, and at T = 1, 15 and 16
    (the depthwise conv's 15-row pad, rows of three utterances in one
    tile); from M = 4096 rows (launch 2 persistent): short utterances, one
    long one with I = 400 (a partial column block), k = 3, and utterances
    shorter than the pad; one launch per call."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_layer_agreement,
                                                       conformer_layer_bf16,
                                                       conformer_layer_bf16_plain)

    gen = torch.Generator().manual_seed(t)
    inner = 2 * c

    def r(*shape, scale):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(cuda)

    x, cond, step = r(b, t, c, scale=1.0), r(b, t, hc, scale=1.0), r(b, c, scale=1.0)
    w = (r(c, hc, scale=hc ** -0.5), r(c, scale=0.1), r(2 * inner, c, scale=c ** -0.5),
         r(2 * inner, scale=0.1), r(inner, k, scale=k ** -0.5), r(inner, scale=0.1),
         r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
    n0 = conformer_layer_bf16.launches
    got = conformer_layer_bf16(x, cond, step, w)
    torch.cuda.synchronize()
    assert conformer_layer_bf16.launches == n0 + 1
    agree = bf16_layer_agreement(got, conformer_layer_bf16_plain(x, cond, step, w), x)
    assert agree["ok"], agree


def test_conformer_layer_bf16_backward(cuda):
    """B3 with grad on: one launch in the forward, none in the backward,
    every .grad plain autograd's of the f32 chain within 1e-4 x max|grad|
    (JAX's ``_fused_layer_bwd`` differentiates the f32 layer whatever
    ``mxu_bf16`` is)."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer as cc

    gen = torch.Generator().manual_seed(8)
    b, t, c, hc, inner, k = 2, 300, 512, 128, 1024, 31
    leaves = _leaves(gen, cuda, ((b, t, c), 1.0), ((b, t, hc), 1.0), ((b, c), 1.0),
                     ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5),
                     ((2 * inner,), 0.1), ((inner, k), k ** -0.5), ((inner,), 0.1),
                     ((c, inner), inner ** -0.5), ((c,), 0.1))
    x, cond, step, *w = leaves
    grad_out = torch.randn((b, t, c), generator=gen).to(cuda)
    n0 = cc.conformer_layer_bf16.launches
    got, got_grads = _backward(lambda: cc.conformer_layer_bf16(x, cond, step, w),
                               leaves, grad_out)
    torch.cuda.synchronize()
    assert cc.conformer_layer_bf16.launches == n0 + 1
    _, want_grads = _backward(lambda: cc.conformer_layer_plain(x, cond, step, w),
                              leaves, grad_out)
    assert cc.conformer_layer_bf16.launches == n0 + 1
    assert cc.bf16_layer_agreement(got, cc.conformer_layer_bf16_plain(
        x.detach(), cond.detach(), step.detach(), [v.detach() for v in w]),
        x.detach())["ok"]
    for g, w_ in zip(got_grads, want_grads):
        assert _rel(g, w_) <= 1e-4


@pytest.mark.parametrize("b,t,c,hc,k,cond16", [
    (48, 172, 512, 128, 31, False), (48, 172, 512, 128, 31, True),
    (1, 862, 512, 128, 31, False), (1, 862, 512, 128, 31, True),
    (2, 101, 128, 16, 31, True), (1, 1, 512, 128, 31, False),
    (3, 15, 512, 128, 31, True), (64, 65, 512, 128, 31, False),
    (1, 4100, 200, 64, 31, True), (5, 1000, 256, 64, 3, False),
    (274, 15, 128, 16, 31, False)])
def test_conformer_layer_bf16_io_kernel(cuda, b, t, c, hc, k, cond16):
    """B5 against its plain version within ``bf16_io_agreement``, at the
    training and the 10 s shapes, cond f32 (the DDSP mel) and bf16, ragged
    T and T = 1 and 15, and from M = 4096 rows (launch 2 persistent) the
    edges B3's test takes; one launch per call, a bf16 output."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_io_agreement,
                                                       conformer_layer_bf16_io,
                                                       conformer_layer_bf16_io_plain)

    gen = torch.Generator().manual_seed(t + 1)
    inner = 2 * c

    def r(*shape, scale):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(cuda)

    x = r(b, t, c, scale=1.0).to(torch.bfloat16)
    cond = r(b, t, hc, scale=1.0)
    cond = cond.to(torch.bfloat16) if cond16 else cond
    step = r(b, c, scale=1.0)
    w = (r(c, hc, scale=hc ** -0.5), r(c, scale=0.1), r(2 * inner, c, scale=c ** -0.5),
         r(2 * inner, scale=0.1), r(inner, k, scale=k ** -0.5), r(inner, scale=0.1),
         r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
    n0 = conformer_layer_bf16_io.launches
    got = conformer_layer_bf16_io(x, cond, step, w)
    torch.cuda.synchronize()
    assert conformer_layer_bf16_io.launches == n0 + 1 and got.dtype == torch.bfloat16
    agree = bf16_io_agreement(got, conformer_layer_bf16_io_plain(x, cond, step, w), x)
    assert agree["ok"], agree


def test_sigmoid_reciprocal_is_the_division(cuda):
    """B3's and B5's branch-free reciprocal (``rcp_fast`` in
    csrc/conformer.cu) equals 1.0f / y at every float y in [1, 2^126), so
    their sigmoids are ``ddsp_sigmoid`` bit for bit."""
    from ddsp_svc_tpu_torch.ops import kernels

    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    kernels.launch("rcp_fast", "ddsp_rcp_fast_mismatches", count.device,
                   count.data_ptr())
    torch.cuda.synchronize()
    assert int(count.item()) == 0


def test_bf16_trunk_on_every_card(cuda):
    """B3 and B5 on each visible card with cuda:0 current (launch 2 at the
    training shape): the wrappers make the tensor's card current and the
    launchers raise the shared-memory limit once per card."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer as cc

    b, t, c, hc, inner, k = 48, 172, 512, 128, 1024, 31
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        gen = torch.Generator().manual_seed(index)

        def r(*shape, scale):
            return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(dev)

        x, cond, step = r(b, t, c, scale=1.0), r(b, t, hc, scale=1.0), r(b, c, scale=1.0)
        w = (r(c, hc, scale=hc ** -0.5), r(c, scale=0.1), r(2 * inner, c, scale=c ** -0.5),
             r(2 * inner, scale=0.1), r(inner, k, scale=k ** -0.5), r(inner, scale=0.1),
             r(c, inner, scale=inner ** -0.5), r(c, scale=0.1))
        assert torch.cuda.current_device() == 0
        got = cc.conformer_layer_bf16(x, cond, step, w)
        assert cc.bf16_layer_agreement(
            got, cc.conformer_layer_bf16_plain(x, cond, step, w), x)["ok"]
        x16 = x.to(torch.bfloat16)
        got16 = cc.conformer_layer_bf16_io(x16, cond, step, w)
        assert cc.bf16_io_agreement(
            got16, cc.conformer_layer_bf16_io_plain(x16, cond, step, w), x16)["ok"]
        torch.cuda.synchronize(dev)


def test_conformer_layer_bf16_io_backward(cuda):
    """B5 with grad on: one launch in the forward, none in the backward;
    every .grad that of the same Function with the plain forward (the f32
    chain at the widened x and cond) within 1e-4 x max|grad|."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer as cc

    gen = torch.Generator().manual_seed(9)
    b, t, c, hc, inner, k = 2, 300, 512, 128, 1024, 31
    leaves = _leaves(gen, cuda, ((b, t, c), 1.0), ((b, t, hc), 1.0), ((b, c), 1.0),
                     ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5),
                     ((2 * inner,), 0.1), ((inner, k), k ** -0.5), ((inner,), 0.1),
                     ((c, inner), inner ** -0.5), ((c,), 0.1))
    with torch.no_grad():
        x = leaves[0].to(torch.bfloat16).requires_grad_(True)
    leaves = [x] + leaves[1:]
    _, cond, step, *w = leaves
    grad_out = torch.randn((b, t, c), generator=gen).to(cuda, torch.bfloat16)
    n0 = cc.conformer_layer_bf16_io.launches
    _, got_grads = _backward(lambda: cc.conformer_layer_bf16_io(x, cond, step, w),
                             leaves, grad_out)
    torch.cuda.synchronize()
    assert cc.conformer_layer_bf16_io.launches == n0 + 1
    _, want_grads = _backward(lambda: cc.ConformerLayerBf16IoFunction.apply(
        cc.conformer_layer_bf16_io_plain, x, cond, step, *w), leaves, grad_out)
    assert cc.conformer_layer_bf16_io.launches == n0 + 1
    for g, w_ in zip(got_grads, want_grads):
        assert _rel(g.float(), w_.float()) <= 1e-4


def test_vocoder_steps_on_the_card(cuda):
    """One discriminator step and one generator step of a small weight-
    normed generator (C 64, rates (4, 4)): K2 launches once per stage in
    each step, B1 (its backward) launches nothing, and the losses and
    gradients agree with the same steps on the CPU (plain versions) within
    1e-4 relative (L2 over each network's gradients)."""
    import copy

    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.nsf_hifigan import Generator
    from ddsp_svc_tpu_torch.ops.cuda_resblock import resblock_group
    from ddsp_svc_tpu_torch.ops.mel import LogMelSpectrogram
    from ddsp_svc_tpu_torch.train import vocoder_solver as vs

    gen = random_init_(Generator(16000, num_mels=32, upsample_rates=(4, 4),
                                 upsample_kernel_sizes=(8, 8),
                                 upsample_initial_channel=64, weight_norm=True),
                       torch.Generator().manual_seed(0))
    discs = random_init_(vs.Discriminators((2, 3), 2), torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    t = 64
    batch = {"mel": rng.standard_normal((2, t, 32)).astype(np.float32) - 3,
             "f0": (150 + 50 * rng.random((2, t, 1))).astype(np.float32),
             "audio": (0.3 * rng.standard_normal((2, t * 16))).astype(np.float32)}
    sine = {"rand_ini": rng.random((1, 1, 9)).astype(np.float32),
            "noise": rng.standard_normal((2, t * 16, 9)).astype(np.float32)}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        g, d = copy.deepcopy(gen).to(dev), copy.deepcopy(discs).to(dev)
        sg, sd = vs.create_states(g, d, 2e-4)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        sk = {k: torch.from_numpy(v).to(dev) for k, v in sine.items()}
        mel = LogMelSpectrogram(sr=16000, n_mels=32, n_fft=256, win_size=256,
                                hop_length=16, fmin=0, fmax=8000).to(dev).extract
        n0 = resblock_group.launches
        md = vs.disc_step(sd, g, b, sine_kwargs=sk)
        n1 = resblock_group.launches
        mg = vs.gen_step(sg, d, b, mel, sine_kwargs=sk)
        n2 = resblock_group.launches
        if dev.type == "cuda":
            assert (n1 - n0, n2 - n1) == (2, 2)
        out[dev.type] = (float(md["disc_loss"]), float(mg["gen_loss"]),
                         {n: p.grad.cpu() for n, p in d.named_parameters()},
                         {n: p.grad.cpu() for n, p in g.named_parameters()})
    (dc, gc, gdc, ggc), (dh, gh, gdh, ggh) = out["cuda"], out["cpu"]
    assert abs(dc - dh) <= 1e-4 * abs(dh) and abs(gc - gh) <= 1e-4 * abs(gh)
    for a, b_ in ((gdc, gdh), (ggc, ggh)):
        num = sum(float(((a[n] - b_[n]) ** 2).sum()) for n in b_)
        den = sum(float((b_[n] ** 2).sum()) for n in b_)
        assert math.sqrt(num / den) <= 1e-4


def test_bf16_trunk_never_serves_stale_weights(cuda):
    """A bf16 trunk layer after an optimizer step launches B3 with its new
    weights (its output is the plain version's on them), where the bf16
    copies made before the step give another output."""
    from ddsp_svc_tpu_torch.models.naive_v2_diff import NaiveV2DiffLayer
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.ops import cuda_conformer as cc

    layer = random_init_(NaiveV2DiffLayer(512, 128, trunk_bf16=True),
                         torch.Generator().manual_seed(1)).to(cuda)
    gen = torch.Generator().manual_seed(2)
    x, cond = (torch.randn(s, generator=gen).to(cuda) for s in ((1, 200, 512),
                                                               (1, 200, 128)))
    diff_step = torch.randn((1, 1, 512), generator=gen).to(cuda)
    opt = torch.optim.AdamW(layer.parameters(), lr=1e-2)
    layer(x, cond, diff_step).square().mean().backward()
    stale = layer.bf16_weights(layer.kernel_weights())
    opt.step()
    with torch.no_grad():
        got = layer(x, cond, diff_step)
        step_vec = layer.diffusion_step_projection(diff_step)[:, 0, :].contiguous()
        weights = layer.kernel_weights()
        want = cc.conformer_layer_bf16_plain(x, cond, step_vec, weights)
        old = cc.conformer_layer_bf16(x, cond, step_vec, weights, stale)
    torch.cuda.synchronize()
    assert cc.bf16_layer_agreement(got, want, x)["ok"]
    assert not cc.bf16_layer_agreement(old, want, x)["ok"]


def test_kernels_refuse_what_they_do_not_take(cuda):
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth

    with pytest.raises(ValueError):
        combtooth(torch.ones((1, 4, 1), device=cuda, dtype=torch.float64), 44100, 512)
    with pytest.raises(ValueError):
        combtooth(torch.ones((1, 4, 2), device=cuda), 44100, 512)
    with pytest.raises(ValueError):  # the offset on another device
        combtooth(torch.ones((1, 4, 1), device=cuda), 44100, 512,
                  torch.zeros((1, 1, 1), dtype=torch.int64))
    with pytest.raises(ValueError):  # not an integer offset
        combtooth(torch.ones((1, 4, 1), device=cuda), 44100, 512,
                  torch.zeros((1, 1, 1), device=cuda))


@pytest.mark.parametrize("b,t,n_harm", [(1, 862, 128), (2, 37, 128), (2, 5, 24)])
def test_harmonic_bank_kernel(cuda, b, t, n_harm):
    """K4 against its plain version: 3e-5 absolute (the JAX oscillator
    test's bound); B = 2 checks that each row's last frame repeats itself."""
    from ddsp_svc_tpu_torch.ops.cuda_oscillator import (harmonic_bank,
                                                        harmonic_bank_plain)
    from ddsp_svc_tpu_torch.ops.source import cumsum_phase_source

    gen = torch.Generator().manual_seed(t)
    f0 = 220.0 * torch.exp(0.2 * torch.randn((b, t, 1), generator=gen))
    x = cumsum_phase_source(torch.repeat_interleave(f0, 512, dim=1), 44100,
                            512).to(cuda)
    amps = (torch.rand((b, t, n_harm), generator=gen) * 0.02).to(cuda)
    n0 = harmonic_bank.launches
    got = harmonic_bank(x, amps, 512)
    want = harmonic_bank_plain(x, amps, 512)
    torch.cuda.synchronize()
    assert harmonic_bank.launches == n0 + 1
    assert float((got - want).abs().max()) <= 3e-5
    with pytest.raises(ValueError):
        harmonic_bank(x[:, :-1].contiguous(), amps, 512)


@pytest.mark.parametrize("b,t,n_harm,block", [(1, 862, 128, 512), (2, 1, 17, 512),
                                             (2, 5, 24, 441), (3, 2, 1, 160)])
def test_harmonic_bank_bf16_amplitude_mode(cuda, b, t, n_harm, block):
    """K4's bf16-amplitude mode (bf16 amplitudes upsampled in bf16, as JAX's
    bf16 Sins) against its plain version, on the card and on the CPU, at
    edge lengths (one frame, one harmonic, a segment of 17 = 16 + 1, a
    block that bf16 rounds, 441 -> 440): 3e-5 absolute at the f32 mode's
    amplitudes (U(0, 0.02), max|out| up to ~2), one launch; with 16 or more
    harmonics the f32 mode on the same widened amplitudes differs by more
    (the bf16 lerp is real)."""
    from ddsp_svc_tpu_torch.ops.cuda_oscillator import (harmonic_bank,
                                                        harmonic_bank_plain)
    from ddsp_svc_tpu_torch.ops.source import cumsum_phase_source

    gen = torch.Generator().manual_seed(t + n_harm)
    f0 = 220.0 * torch.exp(0.2 * torch.randn((b, t, 1), generator=gen))
    x = cumsum_phase_source(torch.repeat_interleave(f0, block, dim=1), 44100,
                            block)
    amps = (torch.rand((b, t, n_harm), generator=gen) * 0.02).to(torch.bfloat16)
    n0 = harmonic_bank.launches
    got = harmonic_bank(x.to(cuda), amps.to(cuda), block)
    want = harmonic_bank_plain(x.to(cuda), amps.to(cuda), block)
    torch.cuda.synchronize()
    assert harmonic_bank.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (b, t * block)
    assert float((got - want).abs().max()) <= 3e-5
    assert float((got.cpu() - harmonic_bank_plain(x, amps, block)).abs().max()) <= 3e-5
    if t > 1 and n_harm >= 16:
        f32 = harmonic_bank(x.to(cuda), amps.float().to(cuda), block)
        assert float((f32 - got).abs().max()) > 3e-5


def _leaves(gen, device, *shapes_scales):
    return [((torch.rand(s, generator=gen) * 2 - 1) * sc).to(device).requires_grad_()
            for s, sc in shapes_scales]


def _backward(fn, leaves, grad_out):
    for leaf in leaves:
        leaf.grad = None
    out = fn()
    out.backward(grad_out)
    return out.detach(), [leaf.grad.clone() for leaf in leaves]


@pytest.mark.parametrize("kernel", ["resblock_group", "conformer_layer",
                                    "harmonic_bank"])
def test_kernel_backward_matches_plain_autograd(cuda, kernel):
    """With grad on, the wrapper launches its kernel once (through its
    autograd.Function) and the backward launches nothing; every input's and
    weight's .grad is plain autograd's within 1e-4 x max|grad| (the backward
    recomputes the plain version; the forward tolerance is kept for the sums
    cuDNN's backward may order otherwise)."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer, cuda_oscillator, cuda_resblock
    from ddsp_svc_tpu_torch.ops.source import cumsum_phase_source

    gen = torch.Generator().manual_seed(7)
    if kernel == "resblock_group":
        c, length = 64, 777
        x, = _leaves(gen, cuda, ((2, length, c), 1.0))
        weights = [[tuple(_leaves(gen, cuda, ((c, c, k), (c * k) ** -0.5),
                                  ((c,), (c * k) ** -0.5)))
                    for _ in range(2 * len(d))] for k, d in zip(KS, DS)]
        leaves = [x] + [t for rbw in weights for wb in rbw for t in wb]
        wrapper = cuda_resblock.resblock_group
        call = lambda: wrapper(x, cuda_resblock.PackedResblocks(weights), KS, DS)  # noqa: E731
        plain = lambda: cuda_resblock.resblock_group_plain(x, weights, KS, DS)  # noqa: E731
    elif kernel == "conformer_layer":
        b, t, c, hc, inner, k = 2, 300, 512, 128, 1024, 31
        leaves = _leaves(gen, cuda, ((b, t, c), 1.0), ((b, t, hc), 1.0), ((b, c), 1.0),
                         ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5),
                         ((2 * inner,), 0.1), ((inner, k), k ** -0.5), ((inner,), 0.1),
                         ((c, inner), inner ** -0.5), ((c,), 0.1))
        x, cond, step, *w = leaves
        wrapper = cuda_conformer.conformer_layer
        call = lambda: wrapper(x, cond, step, w)  # noqa: E731
        plain = lambda: cuda_conformer.conformer_layer_plain(x, cond, step, w)  # noqa: E731
    else:
        b, t, n_harm = 2, 37, 128
        f0 = 220.0 * torch.exp(0.2 * torch.randn((b, t, 1), generator=gen))
        x = cumsum_phase_source(torch.repeat_interleave(f0, 512, dim=1), 44100,
                                512).to(cuda).requires_grad_()
        amps, = _leaves(gen, cuda, ((b, t, n_harm), 0.02))
        leaves = [x, amps]
        wrapper = cuda_oscillator.harmonic_bank
        call = lambda: wrapper(x, amps, 512)  # noqa: E731
        plain = lambda: cuda_oscillator.harmonic_bank_plain(x, amps, 512)  # noqa: E731
    with torch.no_grad():
        grad_out = torch.randn(plain().shape, generator=gen).to(cuda)
    n0 = wrapper.launches
    got, got_grads = _backward(call, leaves, grad_out)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    want, want_grads = _backward(plain, leaves, grad_out)
    assert wrapper.launches == n0 + 1
    assert _rel(got, want) <= 1e-4
    for g, w_ in zip(got_grads, want_grads):
        assert _rel(g, w_) <= 1e-4


def test_combtooth_refuses_an_f0_that_requires_grad(cuda):
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth

    f0 = torch.full((1, 8, 1), 220.0, device=cuda, requires_grad=True)
    n0 = combtooth.launches
    with pytest.raises(RuntimeError, match="no backward"):
        combtooth(f0, 44100, 512)
    assert combtooth.launches == n0
    with torch.no_grad():
        combtooth(f0, 44100, 512)
    assert combtooth.launches == n0 + 1


@pytest.mark.parametrize("name", ["combtooth", "conformer_layer", "harmonic_bank"])
def test_registered_operator_launches_the_kernel(cuda, name, monkeypatch):
    """Each kernel's operator (``torch.ops.ddsp_svc.*``, what an exported
    program calls) on CUDA tensors launches the kernel once, counted, never
    its plain version, and agrees with the plain version within the
    kernel's tolerance; on CPU tensors it is the plain version."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer, cuda_oscillator, cuda_source

    gen = torch.Generator().manual_seed(7)
    if name == "combtooth":
        module, plain = cuda_source, "combtooth_plain"
        args = (_vibrato_f0(1, 862, cuda), None, 44100.0, 512)
        tol, rel = 5e-5, False
    elif name == "conformer_layer":
        module, plain = cuda_conformer, "conformer_layer_plain"
        c, hc, inner, k = 512, 128, 1024, 31
        shapes = [(c, hc), (c,), (2 * inner, c), (2 * inner,), (inner, k),
                  (inner,), (c, inner), (c,)]
        w = [(torch.randn(s, generator=gen) / math.sqrt(s[-1])).to(cuda) for s in shapes]
        args = (torch.randn(1, 862, c, generator=gen).to(cuda),
                torch.randn(1, 862, hc, generator=gen).to(cuda),
                torch.randn(1, c, generator=gen).to(cuda), w)
        tol, rel = 1e-4, True
    else:
        module, plain = cuda_oscillator, "harmonic_bank_plain"
        args = (torch.rand(1, 862 * 512, 1, generator=gen).to(cuda),
                torch.rand(1, 862, 128, generator=gen).to(cuda) * 0.01, 512)
        tol, rel = 3e-5, False
    op = getattr(torch.ops.ddsp_svc, name).default
    want = getattr(module, plain)(*((args[0], args[2], args[3], args[1])
                                    if name == "combtooth" else args))
    wrapper = getattr(module, name)
    n0 = wrapper.launches
    monkeypatch.setattr(module, plain, lambda *a, **k: pytest.fail("plain ran"))
    got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    got, want = (got[0], want[0]) if name == "combtooth" else (got, want)
    err = float((got - want).abs().max())
    assert err <= (tol * float(want.abs().max()) if rel else tol), err
    monkeypatch.undo()
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else
                [t.cpu() for t in a] if isinstance(a, list) else a for a in args]
    cpu = op(*cpu_args)
    cpu = cpu[0] if name == "combtooth" else cpu
    assert wrapper.launches == n0 + 1 and cpu.device.type == "cpu"
