"""B5, K3's bf16 class on bf16 activations
(``ops/cuda_conformer.conformer_layer_bf16_io``), against the JAX package:
the plain version against ``fused_conformer_layer`` on a bf16 x in
interpret mode (cond f32 as the DDSP mel arrives, and bf16) within
``bf16_io_agreement``; its gradients against ``jax.vjp`` of the chain JAX's
custom VJP differentiates (``_stock_layer`` with the cotangent rounded to
bf16), where the package's own VJP refuses the bf16 cotangent; the
tolerance's two sides against float64 sums; and a bf16 NaiveV2Diff running
every layer through B5 and none through K3 or B3."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.ops.pallas_conformer as jpc
from ddsp_svc_tpu_torch.ops import cuda_conformer
from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_io_agreement,
                                                   conformer_layer_bf16_io,
                                                   conformer_layer_bf16_io_plain)
from test_torch_b3 import _inputs, _torch_weights


def _jax_b5(x, cond, sv, w):
    """JAX's fused layer on a bf16 x (mxu_bf16, interpret mode)."""
    return jpc._fused_layer_impl(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cond), jnp.asarray(sv),
        tuple(jnp.asarray(a) for a in w), 16, True, True)


@pytest.mark.parametrize("t,cond16", [(40, False), (33, True)])
def test_plain_matches_pallas_on_bf16_x(t, cond16):
    x, cond, sv, w = _inputs(t=t)
    if cond16:
        cond = np.asarray(jnp.asarray(cond, jnp.bfloat16).astype(jnp.float32))
    want = _jax_b5(x, jnp.asarray(cond, jnp.bfloat16) if cond16 else cond, sv, w)
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(x).bfloat16()
    ct = torch.from_numpy(cond)
    got = conformer_layer_bf16_io_plain(
        xt, ct.bfloat16() if cond16 else ct, torch.from_numpy(sv), _torch_weights(w))
    assert got.dtype == torch.bfloat16
    a = bf16_io_agreement(got, torch.from_numpy(np.asarray(want.astype(jnp.float32))), xt)
    assert a["ok"], a


def test_gradients_match_jax_vjp():
    """Every input's gradient through the wrapper on the CPU (the Function
    with the plain forward) against ``jax.vjp`` of ``_stock_layer`` at the
    bf16 x and cond with the cotangent rounded to bf16: x's and a bf16
    cond's gradients are bf16 (one ulp), the rest at 1e-5 x max|grad|."""
    x, cond, sv, w = _inputs(t=33, c=64, hc=16)
    rng = np.random.default_rng(5)
    g = rng.standard_normal(x.shape).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    cb = jnp.asarray(cond, jnp.bfloat16)
    with pytest.raises(Exception, match="VJP|cotangent|type"):  # JAX's own VJP
        jax.grad(lambda a: jpc.fused_conformer_layer(
            a, cb, jnp.asarray(sv), tuple(jnp.asarray(v) for v in w),
            block_rows=16, interpret=True).astype(jnp.float32).sum())(xb)
    out, vjp = jax.vjp(jpc._stock_layer, xb, cb, jnp.asarray(sv),
                       tuple(jnp.asarray(v) for v in w))
    want = vjp(jnp.asarray(g, jnp.bfloat16).astype(out.dtype))
    assert want[0].dtype == jnp.bfloat16 and want[1].dtype == jnp.bfloat16

    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ct = torch.from_numpy(cond).bfloat16().requires_grad_(True)
    st = torch.from_numpy(sv).requires_grad_(True)
    wt = _torch_weights(w, requires_grad=True)
    conformer_layer_bf16_io(xt, ct, st, wt).backward(torch.from_numpy(g).bfloat16())
    assert xt.grad.dtype == torch.bfloat16 and ct.grad.dtype == torch.bfloat16
    for got, ref in ((xt.grad, want[0]), (ct.grad, want[1])):
        ref = np.asarray(ref.astype(jnp.float32))
        ulp = cuda_conformer.bf16_ulp(torch.from_numpy(ref)).numpy()
        assert (np.abs(got.float().numpy() - ref) <= ulp).all()
    wants = [want[2]] + [a.T if a.ndim == 2 else a for a in want[3]]
    for got, ref in zip([st.grad] + [v.grad for v in wt], wants):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, err


def _exact(x, cond, sv, w, fault=None):
    """B5's function with float64 sums, or a planted fault: "h" (an extra
    bf16 rounding of h before its bias), "twice" (the branch rounded before
    x is added)."""
    r = lambda v: v.to(torch.bfloat16).double()  # noqa: E731
    wc, bc, w1, b1, wd, bd, w2, b2 = (v.double() for v in w)
    hp = r(cond) @ r(wc).t()
    if fault == "h":
        hp = r(hp)
    h = x.double() + r(sv)[:, None, :] + hp + bc
    a, gate = (r(h) @ r(w1).t() + b1).chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    # the depthwise conv as a float64 sum over each padded window (torch's
    # float64 grouped conv1d is the slow reference path on the CPU)
    k = wd.shape[-1]
    windows = F.pad(u, (0, 0, k // 2, k // 2)).unfold(1, k, 1)  # (B, T, I, k)
    v = (windows * wd).sum(-1) + bd
    y = r(v * torch.sigmoid(v)) @ r(w2).t() + b2
    if fault == "twice":
        y = r(y)
    return (x.double() + y).to(torch.bfloat16)


@pytest.mark.parametrize("b,t", [(2, 172)])
def test_tolerance_against_exact_sums(b, t):
    """The plain version (torch's f32 sums) passes ``bf16_io_agreement``
    against float64 sums at the training crop (C 512, Hc 128, I 1024,
    k 31); both planted faults fail it (phase 3 of chip_smoke.py does the
    same with the kernel at B 48 x T 172)."""
    g = torch.Generator().manual_seed(b * 1000 + t)
    c, hc, inner, k = 512, 128, 1024, 31
    x = torch.randn(b, t, c, generator=g).bfloat16()
    cond = torch.randn(b, t, hc, generator=g)
    sv = torch.randn(b, c, generator=g) * 0.5
    w = [torch.randn(*s, generator=g) * sc for s, sc in (
        ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5),
        ((2 * inner,), 0.1), ((inner, k), k ** -0.5), ((inner,), 0.1),
        ((c, inner), inner ** -0.5), ((c,), 0.1))]
    exact = _exact(x, cond, sv, w)
    assert bf16_io_agreement(conformer_layer_bf16_io_plain(x, cond, sv, w),
                             exact, x)["ok"]
    for fault in ("h", "twice"):
        a = bf16_io_agreement(_exact(x, cond, sv, w, fault), exact, x)
        assert not a["ok"], (fault, a)


def test_bf16_trunk_runs_b5(monkeypatch):
    """A bf16 NaiveV2Diff (``set_compute_dtype``) runs each layer through
    B5 with bf16 activations and the step projection in f32, and never K3
    or B3 (the plain versions counted as launches on the CPU)."""
    from ddsp_svc_tpu_torch.models.naive_v2_diff import NaiveV2Diff
    from ddsp_svc_tpu_torch.models.nn import random_init_, set_compute_dtype

    calls = {"b5": 0, "k3": 0, "b3": 0}
    for name, key in (("conformer_layer_bf16_io_plain", "b5"),
                      ("conformer_layer_plain", "k3"),
                      ("conformer_layer_bf16_plain", "b3")):
        fn = getattr(cuda_conformer, name)
        monkeypatch.setattr(cuda_conformer, name,
                            lambda *a, fn=fn, key=key: calls.__setitem__(
                                key, calls[key] + 1) or fn(*a))
    net = random_init_(NaiveV2Diff(32, 64, 32, num_layers=3),
                       torch.Generator().manual_seed(0))
    set_compute_dtype(net, torch.bfloat16)
    out = net(torch.randn(2, 20, 32), torch.tensor([3.0, 500.0]),
              torch.randn(2, 20, 32))
    assert out.dtype == torch.bfloat16
    assert calls == {"b5": 3, "k3": 0, "b3": 0}


def test_b5_refuses_what_it_does_not_take():
    x, cond, sv, w = (torch.zeros(1, 4, 16), torch.zeros(1, 4, 8),
                      torch.zeros(1, 16), [torch.zeros(1)] * 8)
    with pytest.raises(ValueError, match="bf16 x"):
        conformer_layer_bf16_io(x, cond, sv, w)
    with pytest.raises(ValueError, match="bf16 x"):
        conformer_layer_bf16_io(x.bfloat16(), cond.double(), sv, w)
