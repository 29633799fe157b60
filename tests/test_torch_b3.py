"""B3, K3's bf16 class (``ops/cuda_conformer.conformer_layer_bf16``), and the
bf16 trunk (``trunk_bf16``) against the JAX package: the plain version
against ``fused_conformer_layer(..., interpret=True, mxu_bf16=True)`` within
``bf16_layer_agreement``, its SNR against the f32 layer (> 35 dB, the JAX
package's class check), its gradients against ``jax.vjp`` of the same call
(the f32 chain, as ``_fused_layer_bwd``), the tolerance's two sides against
exact sums, the per-model bf16 weight cache under in-place updates, and a
cascade built with the option against JAX's ``trunk_pallas=True`` cascade."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.ops.pallas_conformer as jpc
from ddsp_svc_tpu.ops.pallas_conformer import fused_conformer_layer
from ddsp_svc_tpu_torch.ops import cuda_conformer
from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_layer_agreement,
                                                   bf16_round,
                                                   conformer_layer_bf16,
                                                   conformer_layer_bf16_plain,
                                                   conformer_layer_plain)


def _inputs(b=2, t=40, c=128, hc=32, k=7, seed=0):
    """The JAX package's own test inputs (tests/test_pallas_conformer.py
    ``_mk``): numpy arrays in the JAX layout."""
    rng = np.random.default_rng(seed)
    inner = 2 * c
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    cond = rng.standard_normal((b, t, hc)).astype(np.float32)
    sv = rng.standard_normal((b, c)).astype(np.float32)
    w = (rng.standard_normal((hc, c)) * 0.1, rng.standard_normal((c,)) * 0.1,
         rng.standard_normal((c, 2 * inner)) * 0.05,
         rng.standard_normal((2 * inner,)) * 0.1,
         rng.standard_normal((k, inner)) * 0.2, rng.standard_normal((inner,)) * 0.1,
         rng.standard_normal((inner, c)) * 0.05, rng.standard_normal((c,)) * 0.1)
    return x, cond, sv, tuple(np.asarray(a, np.float32) for a in w)


def _torch_weights(w, requires_grad=False):
    """JAX layout (Wc (Hc, C), bc, W1 (C, 2I), b1, wd (k, I), bd, W2 (I, C),
    b2) -> the kernel's torch layout."""
    wc, bc, w1, b1, wd, bd, w2, b2 = w
    out = [wc.T, bc, w1.T, b1, wd.T, bd, w2.T, b2]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(requires_grad)
                 for a in out)


def _jax_layer(x, cond, sv, w, **kw):
    return fused_conformer_layer(jnp.asarray(x), jnp.asarray(cond),
                                 jnp.asarray(sv), tuple(jnp.asarray(a) for a in w),
                                 block_rows=16, interpret=True, **kw)


@pytest.mark.parametrize("t", [40, 33])
def test_plain_matches_pallas_bf16_class(t):
    """The plain version against the Pallas kernel with mxu_bf16 in
    interpret mode, at the JAX test's shapes and a ragged T: within
    ``bf16_layer_agreement`` (other f32 sum orders flip bf16 roundings)."""
    x, cond, sv, w = _inputs(t=t)
    want = np.asarray(_jax_layer(x, cond, sv, w, mxu_bf16=True))
    xt = torch.from_numpy(x)
    got = conformer_layer_bf16_plain(xt, torch.from_numpy(cond),
                                     torch.from_numpy(sv), _torch_weights(w))
    agree = bf16_layer_agreement(got, torch.from_numpy(want), xt)
    assert agree["ok"], agree
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(conformer_layer_bf16(xt, torch.from_numpy(cond),
                                            torch.from_numpy(sv),
                                            _torch_weights(w)), got)


def _layer_with_stored_bf16(x, cond, step_vec, weights):
    """B3 as its kernel stores it: h and s kept as bf16 tensors, each
    rounded once (nearest even) from its f32 value, and read back by the
    next GEMM; u, the bias sums and the residual in f32."""
    import torch.nn.functional as F

    wc, bc, w1, b1, wd, bd, w2, b2 = weights
    h = (x + step_vec[:, None, :] + torch.matmul(bf16_round(cond), bf16_round(wc).t())
         + bc).to(torch.bfloat16)
    g = torch.matmul(h.float(), bf16_round(w1).t()) + b1
    a, gate = g.chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    k = wd.shape[-1]
    v = F.conv1d(u.transpose(1, 2), wd[:, None, :], padding=(k - 1) // 2,
                 groups=u.shape[-1]).transpose(1, 2) + bd
    s = (v * torch.sigmoid(v)).to(torch.bfloat16)
    return x + torch.matmul(s.float(), bf16_round(w2).t()) + b2


@pytest.mark.parametrize("b,t,c,hc,k", [(2, 40, 128, 32, 7), (1, 37, 64, 16, 31),
                                        (2, 23, 512, 128, 31)])
def test_stored_bf16_intermediates_equal_the_plain_version(b, t, c, hc, k):
    """The kernel stores h and s in bf16 where the plain version rounds
    them at their use: the same function, bit for bit."""
    x, cond, sv, w = _inputs(b=b, t=t, c=c, hc=hc, k=k, seed=t)
    args = (torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(sv),
            _torch_weights(w))
    assert torch.equal(_layer_with_stored_bf16(*args),
                       conformer_layer_bf16_plain(*args))


def test_snr_against_the_f32_layer():
    """The JAX package's class check (test_pallas_conformer.py:95-106):
    > 35 dB from the f32 layer, and not equal to it."""
    x, cond, sv, w = _inputs(t=48, seed=9)
    tw = _torch_weights(w)
    args = (torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(sv))
    exact = conformer_layer_plain(*args, tw).double()
    fast = conformer_layer_bf16_plain(*args, tw).double()
    snr = 10 * torch.log10((exact ** 2).sum() / ((fast - exact) ** 2).sum())
    assert 35.0 < float(snr) < 120.0, float(snr)


def test_gradients_match_jax_vjp():
    """.grad of x, cond, step_vec and all eight weights through the wrapper
    (``ConformerLayerBf16Function``: the bf16 forward, the f32 chain
    backward) against ``jax.vjp`` of the bf16 Pallas call, at 1e-5 x
    max|grad|."""
    x, cond, sv, w = _inputs(t=24, seed=4)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    out, vjp = jax.vjp(
        lambda xx, cc, ss, ww: fused_conformer_layer(
            xx, cc, ss, ww, block_rows=16, interpret=True, mxu_bf16=True),
        jnp.asarray(x), jnp.asarray(cond), jnp.asarray(sv),
        tuple(jnp.asarray(a) for a in w))
    jx, jc, js, jw = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, cond, sv)]
    tw = _torch_weights(w, requires_grad=True)
    got = conformer_layer_bf16(*leaves, tw)
    agree = bf16_layer_agreement(got.detach(), torch.from_numpy(np.asarray(out)),
                                 leaves[0].detach())
    assert agree["ok"], agree
    got.backward(torch.from_numpy(g))
    jw_torch = [jw[0].T, jw[1], jw[2].T, jw[3], jw[4].T, jw[5], jw[6].T, jw[7]]
    for name, t, want in zip(
            ["x", "cond", "step_vec", "wc", "bc", "w1", "b1", "wd", "bd", "w2", "b2"],
            [*leaves, *tw], [jx, jc, js, *jw_torch]):
        want = np.asarray(want)
        err = np.abs(t.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


def _chain(x, cond, sv, tw, fault=None):
    """B3's function with exact (float64) GEMM sums, or with a planted
    extra bf16 rounding: "h" (h's f32 sum before the bias) or "gemm" (each
    GEMM's output)."""
    wc, bc, w1, b1, wd, bd, w2, b2 = tw

    def mm(a, b):
        y = torch.matmul(bf16_round(a).double(), bf16_round(b).t().double()).float()
        return bf16_round(y) if fault == "gemm" else y

    h = x + sv[:, None, :] + mm(cond, wc)
    if fault == "h":
        h = bf16_round(h)
    g = mm(h + bc, w1) + b1
    a, gate = g.chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    k = wd.shape[-1]
    v = torch.nn.functional.conv1d(u.transpose(1, 2), wd[:, None, :],
                                   padding=(k - 1) // 2,
                                   groups=u.shape[-1]).transpose(1, 2) + bd
    s = v * torch.sigmoid(v)
    return x + mm(s, w2) + b2


@pytest.mark.parametrize("variant", ["plain", "fault_h", "fault_gemm", "f32"])
def test_agreement_sum_orders_and_faults(variant):
    """The tolerance's two sides against exact sums at a 512-wide layer:
    torch's f32 sums pass; an extra bf16 rounding of h or of each GEMM's
    output fails, and so does the f32 layer, which rounds nothing."""
    rng = np.random.default_rng(11)
    b, t, c, hc, inner, k = 2, 64, 512, 128, 1024, 31
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((b, t, hc)).astype(np.float32))
    sv = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    tw = tuple(torch.from_numpy((rng.uniform(-1, 1, shape) * s).astype(np.float32))
               for shape, s in (((c, hc), hc ** -.5), ((c,), hc ** -.5),
                                ((2 * inner, c), c ** -.5), ((2 * inner,), c ** -.5),
                                ((inner, k), k ** -.5), ((inner,), k ** -.5),
                                ((c, inner), inner ** -.5), ((c,), inner ** -.5)))
    exact = _chain(x, cond, sv, tw)
    got = {"plain": lambda: conformer_layer_bf16_plain(x, cond, sv, tw),
           "fault_h": lambda: _chain(x, cond, sv, tw, "h"),
           "fault_gemm": lambda: _chain(x, cond, sv, tw, "gemm"),
           "f32": lambda: conformer_layer_plain(x, cond, sv, tw)}[variant]()
    agree = bf16_layer_agreement(got, exact, x)
    assert agree["ok"] == (variant == "plain"), agree


def test_bf16_weight_cache_follows_updates():
    """The trunk layer's bf16 weight copies are re-made after an in-place
    update (an optimizer step), never served stale, and kept while the
    weights stay as they are."""
    from ddsp_svc_tpu_torch.models.naive_v2_diff import NaiveV2DiffLayer
    from ddsp_svc_tpu_torch.models.nn import random_init_

    layer = random_init_(NaiveV2DiffLayer(16, 8, trunk_bf16=True),
                         torch.Generator().manual_seed(0))
    first = layer.bf16_weights(layer.kernel_weights())
    assert layer.bf16_weights(layer.kernel_weights()) is first
    with torch.no_grad():
        layer.conformer.conv1.weight.mul_(2.0)
    second = layer.bf16_weights(layer.kernel_weights())
    assert second is not first
    assert torch.equal(second[1].float(),
                       bf16_round(layer.conformer.conv1.weight[:, :, 0]))
    opt = torch.optim.SGD(layer.parameters(), lr=0.1)
    x = torch.randn(1, 5, 16)
    layer(x, torch.randn(1, 5, 8), torch.randn(1, 1, 16)).sum().backward()
    opt.step()
    third = layer.bf16_weights(layer.kernel_weights())
    assert torch.equal(third[0].float(),
                       bf16_round(layer.condition_projection.weight[:, :, 0]))
    assert torch.equal(third[2].float(),
                       bf16_round(layer.conformer.conv2.weight[:, :, 0]))


def test_cascade_with_the_bf16_trunk(monkeypatch):
    """Unit2WavFast(trunk_bf16=True) runs every trunk layer through B3 and
    none through K3 (the plain versions counted as launches on the CPU),
    and its mel agrees with JAX's trunk_pallas=True cascade (the bf16
    kernel in interpret mode) on the same parameters and draws."""
    from ddsp_svc_tpu.models.cascade import Unit2WavFast as JUnit2WavFast
    from ddsp_svc_tpu_torch.io.jax_params import load_state, model_state_dict
    from ddsp_svc_tpu_torch.models.cascade import Unit2WavFast
    from ddsp_svc_tpu_torch.utils.config import DotDict
    from torch_helpers import randomize_tree

    sr, block, win, n_unit, t = 16000, 64, 256, 32, 24
    jmodel = JUnit2WavFast(sr, block, win, n_unit, 1, out_dims=32, n_layers=2,
                           n_chans=32, trunk_pallas=True)
    monkeypatch.setattr(jpc, "fused_conformer_layer",
                        lambda *a, **kw: fused_conformer_layer(
                            *a, **dict(kw, interpret=True, block_rows=32)))
    rng = np.random.default_rng(3)
    units = rng.standard_normal((1, t, n_unit)).astype(np.float32)
    f0 = np.full((1, t, 1), 220.0, np.float32)
    vol = rng.uniform(0.1, 0.5, (1, t, 1)).astype(np.float32)
    gt = rng.standard_normal((1, t, 32)).astype(np.float32) - 4.0
    noise = rng.standard_normal((1, t * block)).astype(np.float32)
    init = rng.standard_normal((1, t, 32)).astype(np.float32)
    params = randomize_tree(jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        units, f0, vol, gt_spec=gt, k_step=20))["params"], seed=6)
    want = np.asarray(jmodel.apply({"params": params}, units, f0, vol,
                                   gt_spec=gt, k_step=20, infer_speedup=10,
                                   ddsp_noise=noise, init_noise=init,
                                   key=jax.random.PRNGKey(0)))

    port = Unit2WavFast(sr, block, win, n_unit, 1, out_dims=32, n_layers=2,
                        n_chans=32, trunk_bf16=True)
    load_state(port, model_state_dict(DotDict(type="DiffusionFast", n_layers=2),
                                      params))
    counts = {"k3": 0, "b3": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cuda_conformer, "conformer_layer_plain",
                        counted("k3", conformer_layer_plain))
    monkeypatch.setattr(cuda_conformer, "conformer_layer_bf16_plain",
                        counted("b3", conformer_layer_bf16_plain))
    with torch.no_grad():
        got = port(torch.from_numpy(units), torch.from_numpy(f0),
                   torch.from_numpy(vol), mel_extract_fn=lambda a: torch.from_numpy(gt),
                   k_step=20,
                   infer_speedup=10, ddsp_noise=torch.from_numpy(noise),
                   init_noise=torch.from_numpy(init))
    assert counts == {"k3": 0, "b3": 2 * 2}, counts  # 2 DPM steps x 2 layers
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 2e-3, err
