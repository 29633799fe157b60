"""The evaluation orders of K4 (the harmonic bank) and K1 (the combtooth
exciter's frame increments and carry scan), emulated on the CPU in numpy
float32 step by step, against the plain versions the kernels are held to
on the card. The CUDA sources cannot run here; these tests hold their
arithmetic, with the kernels' own constants read from the sources.

K4 follows each sample's harmonics by the three-term recurrence
s_{k+1} = 2 cos(th) s_k - s_{k-1}, restarted every ``kRestart`` harmonics
from an exact sincos of the plain version's rounded argument; tolerance
3e-5 absolute, the JAX oscillator test's bound. K1 derives its frame
increments in the plain version's f32 order and sums them by a blocked
look-back scan in int32; both are held bit for bit.

K4's bf16-amplitude mode upsamples each amplitude as JAX's bf16 upsample,
bf16(bf16(a0 (1 - w)) + bf16(a1 w)), each op in f32 rounded to bf16, and
computes it with packed bf16x2 multiplies and adds, which round the exact
result once. The tests below prove the two the same for every weight of a
512-sample block and hold the packed order within 3e-5 of the plain
version."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddsp_svc_tpu.models.ddsp import sins_harmonic_bank as j_sins_bank
from ddsp_svc_tpu_torch.ops.cuda_oscillator import (bf16_upsample_weights,
                                                    harmonic_bank_plain)
from ddsp_svc_tpu_torch.ops.interp import remove_above_fmax
from ddsp_svc_tpu_torch.ops.source import (PHASE_Q_BITS,
                                           carry_from_increments_q,
                                           cumsum_phase_source,
                                           frame_phase_increments_q)
import torch_helpers  # noqa: F401,E402  (torch's threads under xdist)

CSRC = Path(__file__).resolve().parent.parent / "ddsp_svc_tpu_torch" / "csrc"
SR, BLOCK = 44100, 512


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


K4_RESTART = _constant("oscillator.cu", "kRestart")
K1_FRAMES = tuple(_constant("combtooth.cu", name)
                  for name in ("kMinFrames", "kMaxFrames", "kWaveBlocks"))


def k1_frames_per_block(batch: int, n_frames: int) -> int:
    """``frames_per_block`` of csrc/combtooth.cu."""
    lo, hi, wave = K1_FRAMES
    return min(hi, max(lo, -(-batch * n_frames // wave)))


def _r32(v):
    return np.asarray(v, np.float64).astype(np.float32)


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding of the sum (a
    double rounding through float64, off by an ulp in rare ties)."""
    return _r32(np.asarray(a, np.float64) * b + np.asarray(c, np.float64))


def _mul(a, b):
    return _r32(np.asarray(a, np.float64) * b)


def bank_emulated(x: np.ndarray, amps: np.ndarray, block: int,
                  restart: int) -> np.ndarray:
    """K4's arithmetic (csrc/oscillator.cu) in numpy: x (B, L) cycles,
    amps (B, T, K) -> (B, L)."""
    b, t, n_harm = amps.shape
    xr = x.reshape(b, t, block)
    nxt = np.concatenate([amps[:, 1:], amps[:, -1:]], axis=1)
    mult = _r32(2 * math.pi * np.arange(1, n_harm + 1, dtype=np.float64))
    base = _mul(mult[0], xr)
    s1 = _r32(np.sin(base.astype(np.float64)))
    c1 = _r32(np.cos(base.astype(np.float64)))
    two_c = 2.0 * c1
    acc0 = np.zeros_like(xr)
    acc1 = np.zeros_like(xr)
    s = sp = co = None
    for k in range(n_harm):
        if k % restart == 0:  # exact sincos of the plain version's argument
            arg = _mul(mult[k], xr).astype(np.float64)
            s, co = _r32(np.sin(arg)), _r32(np.cos(arg))
        elif k % restart == 1:  # rotation by th
            sp, s = s, _fma(s, c1, _mul(co, s1))
        else:  # three-term recurrence
            sp, s = s, _fma(two_c, s, -sp.astype(np.float64))
        acc0 = _fma(s, amps[:, :, None, k], acc0)
        acc1 = _fma(s, nxt[:, :, None, k], acc1)
    w = _r32(np.arange(block, dtype=np.float32) / np.float32(block))
    out = _fma(acc0, np.float32(1.0) - w, _mul(acc1, w))
    return out.reshape(b, t * block)


def _vibrato_f0(b: int, t: int) -> torch.Tensor:
    """220 Hz (x 1.5 per further row) with 5.5 Hz vibrato and an unvoiced
    tenth, as chip_smoke.py drives the kernels: (B, T, 1)."""
    time_s = np.arange(t) * BLOCK / SR
    f0 = 220.0 * 2.0 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * time_s))
    f0 = np.stack([f0 * (1.0 + 0.5 * i) for i in range(b)])[..., None]
    f0[:, int(0.45 * t):int(0.55 * t)] = 0.0
    return torch.from_numpy(f0.astype(np.float32))


def _bank_inputs(b, t, kind, seed):
    rng = np.random.default_rng(seed)
    f0 = _vibrato_f0(b, t)
    x = cumsum_phase_source(torch.repeat_interleave(f0, BLOCK, dim=1), SR, BLOCK)
    if kind == "smoke":  # chip_smoke.py's amplitudes, zeroed above fmax
        amps = remove_above_fmax(torch.from_numpy(
            np.exp(0.5 * rng.standard_normal((b, t, 128))).astype(np.float32))
            / 128.0, f0, SR / 2)
    elif kind == "uniform":  # the card test's U(0, 0.02)
        amps = torch.from_numpy((rng.random((b, t, 128)) * 0.02).astype(np.float32))
    else:  # every harmonic at 0.02: the errors add most coherently
        amps = torch.full((b, t, 128), 0.02)
    return x.contiguous(), amps.contiguous()


@pytest.mark.parametrize("b,t,kind", [(1, 862, "smoke"), (1, 862, "flat"),
                                      (2, 37, "uniform"), (2, 37, "flat")])
def test_bank_recurrence_within_tolerance(b, t, kind):
    """K4's order at the 10 s shape (1, 862, 128) and at (2, 37, 128)
    stays within 3e-5 absolute of ``harmonic_bank_plain``."""
    x, amps = _bank_inputs(b, t, kind, seed=t)
    want = harmonic_bank_plain(x, amps, BLOCK).numpy()
    got = bank_emulated(x.numpy()[..., 0], amps.numpy(), BLOCK, K4_RESTART)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 3e-5, err


def test_bank_recurrence_matches_jax_model():
    """Against the JAX model's own radians form at (2, 37, 128): the JAX
    test's 3e-5."""
    x, amps = _bank_inputs(2, 37, "uniform", seed=5)
    ref = np.asarray(j_sins_bank(2.0 * np.pi * jnp.asarray(x.numpy()),
                                 jnp.asarray(amps.numpy()), BLOCK))
    got = bank_emulated(x.numpy()[..., 0], amps.numpy(), BLOCK, K4_RESTART)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)


def test_bank_needs_its_restarts():
    """Without restarts the recurrence drifts past the tolerance on the
    coherent input: the test above can see a restart interval too long."""
    x, amps = _bank_inputs(2, 37, "flat", seed=37)
    want = harmonic_bank_plain(x, amps, BLOCK).numpy()
    got = bank_emulated(x.numpy()[..., 0], amps.numpy(), BLOCK, 128)
    assert float(np.abs(got - want).max()) > 3e-5


# ---------------------------------------------------------------- bf16 mode


def bf16_of_f32(v: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even), as float32: what
    ``__float2bfloat16_rn`` does to an f32 op's result (subnormals too)."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


def bf16_once(v: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bf16 (ties to even) in one rounding, as
    float64: the packed bf16x2 ops' rounding of their exact result."""
    v = np.asarray(v, np.float64)
    _, e = np.frexp(v)  # |v| = m 2^e, 0.5 <= m < 1
    quantum = np.maximum(e - 1, -126) - 7  # 8 significant bits, bf16's subnormals
    return np.ldexp(np.round(np.ldexp(v, -quantum)), quantum)


def bf16_values(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _same(a, b) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.array_equal(a, b) and np.array_equal(np.signbit(a), np.signbit(b)))


def test_bf16_products_round_once():
    """bf16(f32(a w)) equals the single rounding of the exact product for
    every w and 1 - w of ``bf16_upsample_weights(512)`` and every positive
    finite bf16 amplitude, subnormals included: the f32 product of two bf16
    values is exact (16 significant bits on a grid no finer than 2^-149)."""
    w, omw = (t.float().numpy().ravel() for t in bf16_upsample_weights(BLOCK))
    amps = bf16_values(np.arange(1, 0x7F80))  # up to the largest finite
    for weight in np.unique(np.concatenate([w, omw])):
        via_f32 = bf16_of_f32(amps * np.float32(weight))
        once = bf16_once(amps.astype(np.float64) * float(weight))
        assert _same(via_f32, once), weight


def _sum_pairs(rng) -> tuple[np.ndarray, np.ndarray]:
    """10^6 random bf16 pairs (any sign, finite sums) and the edge cases: equal
    exponents, exponents 16-30 apart, subnormals with subnormals and with
    normals."""
    def finite(n):  # below 2^126, so that no sum overflows
        bits = rng.integers(0, 1 << 16, n, dtype=np.uint32)
        return bits[(bits >> 7 & 0xFF) < 253]

    a, b = finite(10 ** 6 + 4000), finite(10 ** 6 + 4000)
    n = min(len(a), len(b))
    pairs = [(a[:n], b[:n])]
    sign = lambda k: rng.integers(0, 2, k, dtype=np.uint32) << 15  # noqa: E731
    mant = lambda k: rng.integers(0, 128, k, dtype=np.uint32)  # noqa: E731
    k = 20000
    exp = rng.integers(1, 253, k, dtype=np.uint32)
    pairs.append((sign(k) | exp << 7 | mant(k), sign(k) | exp << 7 | mant(k)))
    for gap in range(16, 31):
        exp = rng.integers(1 + gap, 253, 2000, dtype=np.uint32)
        pairs.append((sign(2000) | exp << 7 | mant(2000),
                      sign(2000) | (exp - gap) << 7 | mant(2000)))
    pairs.append((sign(k) | mant(k), sign(k) | mant(k)))  # both subnormal
    exp = rng.integers(1, 12, k, dtype=np.uint32)
    pairs.append((sign(k) | exp << 7 | mant(k), sign(k) | mant(k)))
    return (np.concatenate([p[0] for p in pairs]),
            np.concatenate([p[1] for p in pairs]))


def test_bf16_sums_round_once():
    """bf16(f32(a + b)) equals the single rounding of the exact sum of two
    bf16 values. Up to 44 binades apart the float64 sum is exact; further
    apart the smaller lies below 2^-36 of a bf16 ulp of the larger, far
    from any rounding boundary, so the exact sum rounds to the larger, and
    so must the f32 route."""
    a_bits, b_bits = _sum_pairs(np.random.default_rng(17))
    a, b = bf16_values(a_bits), bf16_values(b_bits)
    via_f32 = bf16_of_f32(a + b)
    gap = np.abs((a_bits >> 7 & 0xFF).astype(np.int64) - (b_bits >> 7 & 0xFF))
    near = gap <= 44
    assert near.sum() > 10 ** 5 and (~near).sum() > 10 ** 5
    once = bf16_once(a[near].astype(np.float64) + b[near])
    assert _same(via_f32[near], once)
    larger = np.where(np.abs(a) >= np.abs(b), a, b)[~near]
    assert _same(via_f32[~near], larger)


def bank_bf16_emulated(x: np.ndarray, amps16: np.ndarray, block: int,
                       restart: int) -> np.ndarray:
    """K4's bf16-amplitude mode in numpy: K4's sines (the recurrence with
    its restarts), each pair's amplitude from the packed ops' single
    roundings, accumulated by fmaf in harmonic order. amps16 holds bf16
    values as float32."""
    b, t, n_harm = amps16.shape
    xr = x.reshape(b, t, block)
    nxt = np.concatenate([amps16[:, 1:], amps16[:, -1:]], axis=1).astype(np.float64)
    cur = amps16.astype(np.float64)
    w, omw = (v.float().numpy().reshape(block).astype(np.float64)
              for v in bf16_upsample_weights(block))
    mult = _r32(2 * math.pi * np.arange(1, n_harm + 1, dtype=np.float64))
    base = _mul(mult[0], xr)
    s1 = _r32(np.sin(base.astype(np.float64)))
    c1 = _r32(np.cos(base.astype(np.float64)))
    two_c = 2.0 * c1
    acc = np.zeros_like(xr)
    s = sp = co = None
    for k in range(n_harm):
        if k % restart == 0:
            arg = _mul(mult[k], xr).astype(np.float64)
            s, co = _r32(np.sin(arg)), _r32(np.cos(arg))
        elif k % restart == 1:
            sp, s = s, _fma(s, c1, _mul(co, s1))
        else:
            sp, s = s, _fma(two_c, s, -sp.astype(np.float64))
        amp = bf16_once(bf16_once(cur[:, :, None, k] * omw)
                        + bf16_once(nxt[:, :, None, k] * w))
        acc = _fma(s, amp, acc)
    return acc.reshape(b, t * block)


@pytest.mark.parametrize("b,t,kind", [(2, 37, "uniform"), (1, 200, "smoke")])
def test_bank_bf16_packed_order_within_tolerance(b, t, kind):
    """The bf16-amplitude mode's order (packed amplitudes, K4's sines)
    stays within 3e-5 absolute of ``harmonic_bank_plain`` on the same
    bf16 amplitudes."""
    x, amps = _bank_inputs(b, t, kind, seed=t + 1)
    a16 = amps.to(torch.bfloat16)
    want = harmonic_bank_plain(x, a16, BLOCK).numpy()
    got = bank_bf16_emulated(x.numpy()[..., 0], a16.float().numpy(), BLOCK,
                             K4_RESTART)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 3e-5


def increments_emulated(f0: np.ndarray, sr: int, block: int) -> np.ndarray:
    """K1's ``increment_q`` over f0 (B, T) in numpy f32, rounded step by
    step in the plain version's order -> int32 (B, T)."""
    f32 = np.float32
    s0 = f0 / f32(sr)
    ds0 = np.zeros_like(s0)
    ds0[:, :-1] = s0[:, 1:] - s0[:, :-1]
    fb = f32(block)
    ramp = ((f32(0.5) * ds0) * (fb - f32(1.0))) * fb / fb
    rad = s0 * fb + ramp
    wrapped = np.fmod(rad + f32(0.5), f32(1.0)) - f32(0.5)
    return np.rint(wrapped * f32(1 << PHASE_Q_BITS)).astype(np.int32)


def carry_emulated(q: np.ndarray, offset: np.ndarray, inclusive_every: int,
                   frames: int) -> np.ndarray:
    """K1's scan: per batch row, tiles of ``frames`` frames sum their
    increments in uint32; a tile's carry-in is found by looking back in
    windows of 32 tiles, summing aggregates down to the nearest tile that
    has published an inclusive prefix (here every ``inclusive_every``-th
    tile and tile 0); within the tile, the frames' exclusive prefix.
    -> float32 carry (B, T) in cycles."""
    mask, wrap = (1 << PHASE_Q_BITS) - 1, (1 << 32) - 1
    b, t = q.shape
    n_tiles = -(-t // frames)
    out = np.zeros((b, t), np.float32)
    for row in range(b):
        qs = [int(v) & wrap for v in q[row]]  # the int32 bits, as uint32
        agg = [sum(qs[i * frames:(i + 1) * frames]) & wrap for i in range(n_tiles)]
        incl = {}
        for tile in range(n_tiles):
            if tile == 0:
                excl = int(offset[row]) & wrap
            else:
                excl, end, done = 0, tile, False
                while not done:
                    for idx in range(end - 1, max(end - 33, -1), -1):
                        if idx in incl:
                            excl += incl[idx]
                            done = True
                            break
                        excl += agg[idx] & mask
                    end -= 32
                excl &= mask
            if tile == 0 or tile % inclusive_every == 0:
                incl[tile] = (excl + agg[tile]) & mask
            carry_q = excl
            for i in range(tile * frames, min((tile + 1) * frames, t)):
                out[row, i] = np.float32(carry_q & mask) / np.float32(1 << PHASE_Q_BITS)
                carry_q = (carry_q + qs[i]) & wrap
    return out


def test_increments_bit_for_bit():
    """K1's frame increments against ``frame_phase_increments_q`` on
    vibrato, unvoiced stretches and random f0 up to 2 kHz, bit for bit."""
    rng = np.random.default_rng(3)
    f0 = torch.cat([_vibrato_f0(2, 862)[..., 0],
                    torch.from_numpy(rng.uniform(0, 2000, (2, 862)).astype(np.float32))])
    want = frame_phase_increments_q(f0[..., None], SR, BLOCK)[..., 0].numpy()
    got = increments_emulated(f0.numpy(), SR, BLOCK)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inclusive_every", [1, 7, 10 ** 9])
def test_carry_scan_bit_for_bit(inclusive_every):
    """K1's carry scan at T = 2^13 + 5, B = 2, with a ``carry_offset_q``
    (one negative, one past 2^32) against ``carry_from_increments_q``, bit
    for bit, whatever tiles publish their inclusive prefix in time: the
    int32 sums wrap, and the 22-bit residue does not depend on the order."""
    rng = np.random.default_rng(inclusive_every % 97)
    t = (1 << 13) + 5
    q = rng.integers(-(1 << 21), (1 << 21) + 1, (2, t)).astype(np.int32)
    # increments near the extremes make the int32 prefix overflow
    q[:, : t // 2] = (1 << 21) - rng.integers(0, 3, (2, t // 2))
    offset = np.array([-123456789, (1 << 34) + 98765], np.int64)
    want = carry_from_increments_q(torch.from_numpy(q[..., None]),
                                   torch.from_numpy(offset.reshape(2, 1, 1)))
    frames = k1_frames_per_block(2, t)
    assert frames > K1_FRAMES[0]  # the grid passes a wave: F grows
    got = carry_emulated(q, offset, inclusive_every, frames)
    assert np.array_equal(got.view(np.uint32), want[..., 0].numpy().view(np.uint32))
