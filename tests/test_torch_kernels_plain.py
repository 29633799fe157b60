"""The plain PyTorch versions of the port's three kernels against the JAX
package: the stock jnp function and the Pallas kernel in interpret mode
(the same calls tests/test_pallas_*.py make), at the JAX tests' tolerances.
On CPU tensors the wrappers take the plain versions and launch nothing."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.ops.pallas_conformer import _stock_layer, fused_conformer_layer
from ddsp_svc_tpu.ops.pallas_resblock import _stock_group, fused_resblock_group
from ddsp_svc_tpu.ops.pallas_source import combtooth_pallas
from ddsp_svc_tpu.ops.source import (carry_from_increments_q, fast_source_gen,
                                     frame_phase_increments_q)
from ddsp_svc_tpu_torch.ops.cuda_conformer import (conformer_layer,
                                                   conformer_layer_plain)
from ddsp_svc_tpu_torch.ops.cuda_resblock import (resblock_group,
                                                  resblock_group_plain)
from ddsp_svc_tpu_torch.ops.cuda_source import combtooth, combtooth_plain
from torch_helpers import conv_w, f0_contour, tt

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


# ---------------------------------------------------------------- K1


def _combtooth_f64(f0, sr, block):
    """The combtooth formula in float64 on the same integer carry."""
    q = frame_phase_increments_q(jnp.asarray(f0), sr, block)
    carry = np.asarray(carry_from_increments_q(q), np.float64)
    n = np.arange(block, dtype=np.float64)
    s0 = (f0 / np.float32(sr)).astype(np.float64)
    ds0 = np.pad(s0[:, 1:] - s0[:, :-1], ((0, 0), (0, 1), (0, 0)))
    rad = s0 * (n + 1) + 0.5 * ds0 * n * (n + 1) / block + carry
    rad = rad - np.round(rad)
    return np.sinc(rad / (s0 + ds0 * n / block + 1e-5)).reshape(f0.shape[0], -1)


@pytest.mark.parametrize("regime", ["jax_test", "main_path"])
def test_combtooth_plain_matches_jax(regime):
    """5e-5 absolute (tests/test_pallas_source.py's bound) against JAX's
    ``fast_source_gen`` run op by op. Against a float64 evaluation of the
    same formula, 1e-4: one f32 ulp of the phase ramp (~2.4e-7 at |rad| < 4)
    divided by s0 ~ 0.005 moves the sinc argument by ~5e-5. XLA's fused jit
    lowering (and the Pallas kernel in interpret mode under jit) rounds the
    ramp differently and sits up to ~5e-4 from the float64 value, so those
    two are held at 1e-3."""
    if regime == "jax_test":
        rng = np.random.default_rng(0)
        b, t, block, sr = 2, 37, 64, 16000
        f0 = (150.0 * np.exp(0.4 * rng.standard_normal((b, t, 1)))).astype(np.float32)
    else:
        block, sr = 512, 44100
        f0 = f0_contour(40)
    eager, eager_phase = fast_source_gen(jnp.asarray(f0), sr, block)
    jitted, _ = jax.jit(fast_source_gen, static_argnums=(1, 2))(
        jnp.asarray(f0), sr, block)
    pallas, _ = jax.jit(lambda f: combtooth_pallas(f, sr, block, interpret=True))(
        jnp.asarray(f0))
    got, got_phase = combtooth_plain(tt(f0), sr, block)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(eager), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got, _combtooth_f64(f0, sr, block), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_phase.numpy(), np.asarray(eager_phase),
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jitted), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-3, rtol=0)


def test_combtooth_plain_streaming_carry_offset():
    """A block that starts mid-utterance with the JAX integer carry prefix
    continues the whole-utterance phase (2e-6, as the JAX test)."""
    b, t, block, sr = 1, 16, 32, 16000
    f0 = (220.0 * np.ones((b, t, 1))).astype(np.float32)
    q = frame_phase_increments_q(jnp.asarray(f0), sr, block)
    offset = np.array(jnp.sum(q[:, :8], axis=1, keepdims=True))
    whole, _ = combtooth_plain(tt(f0), sr, block)
    half, _ = combtooth_plain(tt(f0[:, 8:]), sr, block,
                              carry_offset_q=torch.from_numpy(offset))
    want, _ = fast_source_gen(jnp.asarray(f0[:, 8:]), sr, block,
                              carry_offset_q=jnp.asarray(offset))
    np.testing.assert_allclose(half.numpy(), whole[:, 8 * block:].numpy(), atol=2e-6)
    np.testing.assert_allclose(half.numpy(), np.asarray(want), atol=5e-5)


# ---------------------------------------------------------------- K2


def _rb_weights(rng, c):
    jax_w, torch_w = [], []
    for k, dils in zip(KS, DS):
        jw, tw = [], []
        bound = 1.0 / np.sqrt(c * k)  # torch's init range: O(1) activations
        for _ in range(2 * len(dils)):
            w = rng.uniform(-bound, bound, (k, c, c)).astype(np.float32)
            b = rng.uniform(-bound, bound, (c,)).astype(np.float32)
            jw.append((jnp.asarray(w), jnp.asarray(b)))
            tw.append((conv_w(w), tt(b)))
        jax_w.append(jw)
        torch_w.append(tw)
    return jax_w, torch_w


@pytest.mark.parametrize("c,length", [(16, 600), (64, 1030)])
def test_resblock_group_plain_matches_jax(c, length):
    """rtol 1e-4 / atol 1e-5 (tests/test_pallas_resblock.py); lengths that
    are no multiple of the Pallas tile, so the utterance edges are exact."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, length, c)).astype(np.float32)
    jax_w, torch_w = _rb_weights(rng, c)
    stock = jax.jit(lambda x_, w_: _stock_group(x_, w_, KS, DS))(jnp.asarray(x), jax_w)
    pallas = jax.jit(lambda x_, w_: fused_resblock_group(
        x_, w_, KS, DS, interpret=True))(jnp.asarray(x), jax_w)
    got = resblock_group_plain(tt(x), torch_w, KS, DS).numpy()
    np.testing.assert_allclose(got, np.asarray(stock), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- K3


def _layer_inputs(b, t, c, hc, k, seed):
    rng = np.random.default_rng(seed)
    inner = 2 * c
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    cond = rng.standard_normal((b, t, hc)).astype(np.float32)
    sv = rng.standard_normal((b, c)).astype(np.float32)
    w = [
        rng.standard_normal((hc, c)) * 0.1, rng.standard_normal((c,)) * 0.1,
        rng.standard_normal((c, 2 * inner)) * 0.05,
        rng.standard_normal((2 * inner,)) * 0.1,
        rng.standard_normal((k, inner)) * 0.2, rng.standard_normal((inner,)) * 0.1,
        rng.standard_normal((inner, c)) * 0.05, rng.standard_normal((c,)) * 0.1,
    ]
    w = [a.astype(np.float32) for a in w]
    # torch layout: matrices transposed to (out, in), depthwise to (I, k)
    tw = tuple(tt(a.T) if a.ndim == 2 else tt(a) for a in w)
    return x, cond, sv, tuple(jnp.asarray(a) for a in w), tw


@pytest.mark.parametrize("t,c,hc,k,block_rows", [(40, 128, 32, 7, 16),
                                                 (33, 64, 128, 31, 32)])
def test_conformer_layer_plain_matches_jax(t, c, hc, k, block_rows):
    """2e-5 (tests/test_pallas_conformer.py, f32 mode); T = 33 leaves a
    ragged tail block."""
    x, cond, sv, jw, tw = _layer_inputs(2, t, c, hc, k, seed=t)
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(sv), jw)
    stock = jax.jit(_stock_layer)(*args)
    pallas = jax.jit(lambda *a: fused_conformer_layer(
        *a, block_rows=block_rows, interpret=True, mxu_bf16=False))(*args)
    got = conformer_layer_plain(tt(x), tt(cond), tt(sv), tw).numpy()
    np.testing.assert_allclose(got, np.asarray(stock), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- dispatch


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    for fn in (combtooth, resblock_group, conformer_layer):
        fn.launches = 0
    rng = np.random.default_rng(5)
    f0 = tt(f0_contour(12))
    got, _ = combtooth(f0, 44100, 512)
    assert torch.equal(got, combtooth_plain(f0, 44100, 512)[0])
    x = tt(rng.standard_normal((1, 96, 16)))
    _, tw = _rb_weights(rng, 16)
    assert torch.equal(resblock_group(x, tw, KS, DS),
                       resblock_group_plain(x, tw, KS, DS))
    xs, cond, sv, _, w = _layer_inputs(1, 20, 32, 16, 7, seed=1)
    assert torch.equal(conformer_layer(tt(xs), tt(cond), tt(sv), w),
                       conformer_layer_plain(tt(xs), tt(cond), tt(sv), w))
    assert (combtooth.launches, resblock_group.launches,
            conformer_layer.launches) == (0, 0, 0)
