"""The kernel wrappers' gradients on the CPU: each ``autograd.Function``
run with its plain forward (on the card the forward is the kernel; the
backward is the same in both) against the JAX package's VJPs on the same
numpy inputs and cotangent:

- K2 ``ResblockGroupFunction`` against ``jax.vjp`` of
  ``fused_resblock_group(..., interpret=True)`` (its custom VJP, the stock
  chain's backward), for x and every (w, b);
- K3 ``ConformerLayerFunction`` against ``jax.vjp`` of
  ``fused_conformer_layer(..., interpret=True, mxu_bf16=False)``, for x,
  cond, step_vec and the eight weights;
- K4 ``HarmonicBankFunction`` against ``jax.vjp`` of the stock
  ``sins_harmonic_bank`` the JAX Sins model differentiates (phase 2 pi x);

each gradient within 1e-5 x its max|grad|. A backward runs no forward
implementation (no kernel launch). K1 refuses an f0 that requires grad."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.ddsp import sins_harmonic_bank
from ddsp_svc_tpu.ops.pallas_conformer import fused_conformer_layer
from ddsp_svc_tpu.ops.pallas_resblock import fused_resblock_group
from ddsp_svc_tpu_torch.ops.cuda_conformer import (ConformerLayerFunction,
                                                   conformer_layer_plain)
from ddsp_svc_tpu_torch.ops.cuda_oscillator import (HarmonicBankFunction,
                                                    harmonic_bank_plain)
from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                  ResblockGroupFunction,
                                                  resblock_group_plain)
from ddsp_svc_tpu_torch.ops.cuda_source import combtooth
from torch_helpers import rel_err

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
TOL = 1e-5


def _counted(fn, calls):
    def impl(*args):
        calls.append(1)
        return fn(*args)
    return impl


def _leaf(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_()


def test_resblock_group_grad_matches_jax_vjp():
    rng = np.random.default_rng(0)
    c, length = 32, 96
    x = rng.standard_normal((2, length, c)).astype(np.float32) * 0.3
    jw = [[(rng.standard_normal((k, c, c)).astype(np.float32) * 0.2,
            rng.standard_normal((c,)).astype(np.float32) * 0.1)
           for _ in range(2 * len(d))] for k, d in zip(KS, DS)]
    g = rng.standard_normal((2, length, c)).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, w_: fused_resblock_group(x_, w_, KS, DS,
                                                           interpret=True),
                       jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, jw))
    gx_want, gw_want = vjp(jnp.asarray(g))

    xt = _leaf(x)
    tw = [[(_leaf(w.transpose(2, 1, 0)), _leaf(b)) for w, b in rbw] for rbw in jw]
    flat = [t for rbw in tw for wb in rbw for t in wb]
    calls = []
    y = ResblockGroupFunction.apply(_counted(resblock_group_plain, calls), xt,
                                    PackedResblocks(tw), KS, DS, *flat)
    assert rel_err(y.detach(), out) <= TOL
    y.backward(torch.from_numpy(g))
    assert len(calls) == 1  # the backward launches nothing
    assert rel_err(xt.grad, gx_want) <= TOL
    for rb_got, rb_want in zip(tw, gw_want):
        for (w, b), (gw, gb) in zip(rb_got, rb_want):
            assert rel_err(w.grad, np.asarray(gw).transpose(2, 1, 0)) <= TOL
            assert rel_err(b.grad, gb) <= TOL


def test_resblock_group_grad_reaches_the_module_weights():
    """The gradient lands on the torch-layout tensors the packed copy was
    made from (the Generator's parameters), not on the packed copy."""
    gen = torch.Generator().manual_seed(1)
    c = 16
    x = torch.randn((1, 40, c), generator=gen, requires_grad=True)
    tw = [[(torch.randn((c, c, k), generator=gen).mul_(0.1).requires_grad_(),
            torch.zeros(c, requires_grad=True)) for _ in range(6)] for k in KS]
    packed = PackedResblocks(tw)
    flat = [t for rbw in tw for wb in rbw for t in wb]
    y = ResblockGroupFunction.apply(resblock_group_plain, x, packed, KS, DS, *flat)
    y.square().sum().backward()
    want = [torch.autograd.grad(resblock_group_plain(x, tw, KS, DS).square().sum(),
                                [x] + flat)]
    for got, ref in zip([x.grad] + [t.grad for t in flat], want[0]):
        assert got is not None and torch.equal(got, ref)


def test_conformer_layer_grad_matches_jax_vjp():
    rng = np.random.default_rng(2)
    b, t, c, hc, inner, k = 2, 40, 64, 32, 128, 7
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    cond = rng.standard_normal((b, t, hc)).astype(np.float32)
    sv = rng.standard_normal((b, c)).astype(np.float32)
    # the port's torch layout: Wc (C, Hc), W1 (2I, C), wd (I, k), W2 (C, I)
    tw = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((c, hc), 0.1), ((c,), 0.1), ((2 * inner, c), 0.05), ((2 * inner,), 0.1),
        ((inner, k), 0.2), ((inner,), 0.1), ((c, inner), 0.05), ((c,), 0.1))]
    jw = tuple(jnp.asarray(w.T if w.ndim == 2 else w) for w in tw)
    g = rng.standard_normal((b, t, c)).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, c_, s_, w_: fused_conformer_layer(
        x_, c_, s_, w_, block_rows=16, interpret=True, mxu_bf16=False),
        jnp.asarray(x), jnp.asarray(cond), jnp.asarray(sv), jw)
    want = vjp(jnp.asarray(g))

    leaves = [_leaf(a) for a in (x, cond, sv, *tw)]
    calls = []
    y = ConformerLayerFunction.apply(_counted(conformer_layer_plain, calls), *leaves)
    assert rel_err(y.detach(), out) <= TOL
    y.backward(torch.from_numpy(g))
    assert len(calls) == 1
    for got, ref in zip(leaves[:3], want[:3]):
        assert rel_err(got.grad, ref) <= TOL
    for got, ref in zip(leaves[3:], want[3]):
        ref = np.asarray(ref)
        assert rel_err(got.grad, ref.T if ref.ndim == 2 else ref) <= TOL


def test_harmonic_bank_grad_matches_jax_stock_bank():
    rng = np.random.default_rng(3)
    b, t, block, n_harm = 2, 12, 64, 40
    # wrapped phase in cycles, as cumsum_phase_source gives it
    x = rng.uniform(-0.5, 0.5, (b, t * block, 1)).astype(np.float32)
    amps = np.exp(rng.standard_normal((b, t, n_harm))).astype(np.float32) / 128.0
    g = rng.standard_normal((b, t * block)).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, a_: sins_harmonic_bank(2.0 * np.pi * x_, a_, block),
                       jnp.asarray(x), jnp.asarray(amps))
    gx_want, ga_want = vjp(jnp.asarray(g))

    xt, at = _leaf(x), _leaf(amps)
    calls = []
    y = HarmonicBankFunction.apply(_counted(harmonic_bank_plain, calls), xt, at, block)
    assert rel_err(y.detach(), out) <= 1e-5
    y.backward(torch.from_numpy(g))
    assert len(calls) == 1
    assert rel_err(at.grad, ga_want) <= TOL
    assert rel_err(xt.grad, gx_want) <= TOL
    assert math.isfinite(float(xt.grad.abs().max()))


def test_combtooth_refuses_an_f0_that_requires_grad():
    f0 = torch.full((1, 6, 1), 220.0, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        combtooth(f0, 44100, 64)
    with torch.no_grad():
        comb, phase = combtooth(f0, 44100, 64)
    assert comb.shape == (1, 6 * 64) and phase.shape == (1, 6, 1)
    comb, _ = combtooth(f0.detach(), 44100, 64)
    assert not comb.requires_grad
