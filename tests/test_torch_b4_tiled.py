"""K2's bf16 class (B4) as its fused kernel tiles it, on the CPU.

The kernel (``csrc/resblock.cu``, ``resblock_fused_bf16_kernel``) keeps a
time tile of ``bm`` output rows plus a halo on the SM through a run of
convs, recomputes the halo, and zeroes rows outside [0, L) before every
conv. ``resblock_group_bf16_tiled`` walks the same plan in plain PyTorch
(``FUSED_PLAN``: tile heights, runs of a stage, a chain or a conv pair,
the f32 buffers between launches). It is held to
``resblock_group_bf16_plain`` and to the Pallas kernel on bf16 x in
interpret mode by the unchanged ``bf16_agreement`` (its convs' sums may run
in another order), at B = 2 with lengths shorter than one tile and no
multiple of it; a planted halo fault (rows outside [0, L) not zeroed after
a conv) must fail that check wherever a run fuses convs. The packing test
pins the layout the kernel's weight ring copies: one tap's C x C tile as
2 C^2 contiguous bytes."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.ops.pallas_resblock import fused_resblock_group
from ddsp_svc_tpu_torch.ops import cuda_resblock
from ddsp_svc_tpu_torch.ops.cuda_resblock import (FUSED_BLOCKS_PER_SM,
                                                  FUSED_PLAN, bf16_agreement,
                                                  fused_rows,
                                                  pack_conv_weight_bf16,
                                                  resblock_group_bf16_plain,
                                                  resblock_group_bf16_tiled,
                                                  unpack_conv_weight_bf16)
from torch_helpers import conv_w, tt

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
BF16 = torch.bfloat16


def _case(c, length, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, length, c)).astype(np.float32)
    jax_w, torch_w = [], []
    for k, dils in zip(KS, DS):
        bound = 1.0 / np.sqrt(c * k)
        jw, tw = [], []
        for _ in range(2 * len(dils)):
            w = rng.uniform(-bound, bound, (k, c, c)).astype(np.float32)
            b = rng.uniform(-bound, bound, (c,)).astype(np.float32)
            jw.append((jnp.asarray(w), jnp.asarray(b)))
            tw.append((conv_w(w), tt(b)))
        jax_w.append(jw)
        torch_w.append(tw)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
    return xb, xt, jax_w, torch_w


# (C, L): the plan's own tile heights (at most 512 rows at C = 16, 232 at
# 32, 224 at 64, 240 at C = 128), each with L below one tile and L a few tiles long
# but no multiple of the tile (the Pallas kernel wants L a multiple of its
# packing, 128 / C)
CASES = [(16, 40), (16, 1096), (32, 8), (32, 600), (64, 100), (64, 302),
         (128, 61), (128, 301)]


@functools.lru_cache(maxsize=None)
def _tiled_case(c, length):
    """(the case, the tiled output) of (C, L), computed once for the tests
    against the plain version and against the Pallas kernel."""
    case = _case(c, length, 700 + c + length)
    return case, resblock_group_bf16_tiled(case[1], case[3], KS, DS)


@pytest.mark.parametrize("c,length", CASES)
def test_tiled_matches_plain(c, length):
    (_, xt, _, torch_w), got = _tiled_case(c, length)
    assert got.dtype == BF16 and got.shape == xt.shape
    agree = bf16_agreement(got, resblock_group_bf16_plain(xt, torch_w, KS, DS))
    assert agree["ok"], agree


# one shape per width against the Pallas kernel (each interpret-mode
# compile takes ~10 s on the CPU)
@pytest.mark.parametrize("c,length", [(16, 40), (32, 600), (64, 100), (128, 301)])
def test_tiled_matches_jax_kernel(c, length):
    (xb, _, jax_w, _), got = _tiled_case(c, length)
    want = jax.jit(lambda x_, w_: fused_resblock_group(
        x_, w_, KS, DS, interpret=True))(xb, jax_w)
    agree = bf16_agreement(got, torch.from_numpy(np.array(want.astype(jnp.float32))))
    assert agree["ok"], agree


@pytest.mark.parametrize("plan", [("stage", 64), ("stage", 216), ("chain", 128),
                                  ("pair", 64), ("pair", 112)])
@pytest.mark.parametrize("c", [16, 32])
def test_every_launch_plan_matches_plain(c, plan):
    """The other runs the kernel can be told to take (one launch a chain or
    a conv pair, with z and the running sum in f32 buffers between
    launches), at tile heights other than the plan's, multiples of 64 or
    not (``fused_rows`` picks any multiple of 8)."""
    _, xt, _, torch_w = _case(c, 333, 900 + c)
    got = resblock_group_bf16_tiled(xt, torch_w, KS, DS, plan=plan)
    agree = bf16_agreement(got, resblock_group_bf16_plain(xt, torch_w, KS, DS))
    assert agree["ok"], agree


@pytest.mark.parametrize("c,length", [(16, 45), (32, 7), (64, 100), (128, 60)])
def test_a_halo_fault_fails_the_tolerance(c, length):
    """Rows outside [0, L) left as the conv computed them (not zeroed before
    the next conv) move the outputs near both ends of each utterance, and
    the tolerance catches it at every width's plan."""
    _, xt, _, torch_w = _case(c, length, 800 + c)
    plain = resblock_group_bf16_plain(xt, torch_w, KS, DS)
    assert bf16_agreement(resblock_group_bf16_tiled(xt, torch_w, KS, DS),
                          plain)["ok"]
    bad = resblock_group_bf16_tiled(xt, torch_w, KS, DS, fault="halo")
    agree = bf16_agreement(bad, plain)
    assert not agree["ok"], agree


def test_plan_covers_the_bf16_widths():
    """Every width the bf16 generator sends to the kernel (C <= 128 with
    128 % C == 0 and C a multiple of 16) has a plan; the tile heights are
    multiples of 8 rows."""
    assert sorted(FUSED_PLAN) == [16, 32, 64, 128]
    for c, (mode, bm) in FUSED_PLAN.items():
        assert mode in ("stage", "chain", "pair") and bm % 8 == 0 and bm >= 64
        n = cuda_resblock._convs_per_launch(mode, 3, 3)
        assert 18 % n == 0


@pytest.mark.parametrize("batch,frames", [(1, 862), (8, 1024), (1, 200), (3, 17),
                                          (1, 1)])
@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_rows_per_block_fill_whole_waves(c, batch, frames):
    """``fused_rows`` keeps the number of waves that the plan's tile height
    would take on 132 SMs and spreads the rows over them: never more waves,
    tiles of 64 to ``bm`` rows in multiples of 8, and at the 10 s request's
    stages a last wave at least 70 % full."""
    import math

    _, bm = FUSED_PLAN[c]
    length = frames * {128: 64, 64: 128, 32: 256, 16: 512}[c]
    slots = 132 * FUSED_BLOCKS_PER_SM[c]
    rows = fused_rows(bm, length, batch, slots)
    assert 64 <= rows <= bm and rows % 8 == 0
    waves = math.ceil(batch * math.ceil(length / rows) / slots)
    assert waves <= math.ceil(batch * math.ceil(length / bm) / slots)
    if (batch, frames) == (1, 862):
        assert batch * math.ceil(length / rows) / slots > waves - 0.3


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_weight_tiles_per_tap_are_contiguous(c):
    """The weight ring copies one tap per slot: packed[tau] is the tap's
    2 C^2 contiguous bytes, in which the k16 step ch (input channels 16 ch
    ... 16 ch + 15) starts at element 16 C ch and holds C / 8 groups of two
    8 x 8 core matrices (rows: output channels, 16 bytes: eight input
    channels); unpacking gives every weight back, rounded to bf16."""
    k = 7
    w = torch.randn((c, c, k), generator=torch.Generator().manual_seed(c))
    packed = pack_conv_weight_bf16(w)
    assert packed.is_contiguous() and packed.dtype == BF16
    assert torch.equal(unpack_conv_weight_bf16(packed), w.to(BF16))
    flat = packed.reshape(k, c * c)
    wb = w.to(BF16)
    for tau in (0, k - 1):
        for ch in range(c // 16):
            tile = flat[tau, 16 * c * ch:16 * c * (ch + 1)].reshape(c // 8, 2, 8, 8)
            for grp in range(c // 8):
                for half in range(2):
                    ci = slice(16 * ch + 8 * half, 16 * ch + 8 * half + 8)
                    assert torch.equal(tile[grp, half], wb[8 * grp:8 * grp + 8, ci, tau])
