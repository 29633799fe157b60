"""``model.use_remat`` in the port: ``remat=True`` recomputes each
NaiveV2Diff layer and each WaveNet residual block in the backward
(``torch.utils.checkpoint``, non-reentrant; JAX ``nn.remat``).

As ``tests/test_remat.py`` holds JAX, the gradients with remat equal those
without it exactly (the recomputed forward is the same arithmetic). Against
JAX's ``remat=True`` gradients, of sum(out^2) on the same parameters, every
leaf is held at GRAD_TOL = 1e-5 x max|grad| of the leaf (the training
parity tests' tolerance; the JAX side jitted once). Under remat the layer's
kernel wrapper runs twice per step (forward and recompute): on the card
K3 (or B3 / B5) launches twice per layer.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.naive_v2_diff import NaiveV2Diff as JNaive
from ddsp_svc_tpu.models.wavenet import WaveNet as JWaveNet
from ddsp_svc_tpu_torch.io.jax_params import (_Leaves, _put_naive_v2_diff,
                                              _put_wavenet, _ToJax, load_state,
                                              wavenet_state_dict)
from ddsp_svc_tpu_torch.models import naive_v2_diff
from ddsp_svc_tpu_torch.models.naive_v2_diff import NaiveV2Diff
from ddsp_svc_tpu_torch.models.wavenet import WaveNet
from torch_helpers import randomize_tree, tt
from torch_train_helpers import leaves

GRAD_TOL = 1e-5
B, T = 2, 24


def _inputs(m, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, m)).astype(np.float32),
            np.array([3.0, 517.0], np.float32),
            rng.standard_normal((B, T, c)).astype(np.float32))


def _jax_grads(jnet, x, t, c, seed):
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x, t, c))
    params = randomize_tree(shapes["params"], seed)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jnet.apply({"params": p}, x, t, c) ** 2)))(params)
    return params, leaves(jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(net, x, t, c) -> dict:
    net.zero_grad(set_to_none=True)
    torch.sum(net(tt(x), tt(t), tt(c)) ** 2).backward()
    return {n: p.grad.clone() for n, p in net.named_parameters()}


def _held(port_grads: dict, want: dict, put, n_layers: int) -> float:
    """max over leaves of |port - JAX| / max|JAX|, the port's gradients
    mapped to the JAX tree by the checkpoint mapping ``put``."""
    named = {f"n.{k}": v for k, v in port_grads.items()}
    tree = _ToJax(named, with_buffers=False)
    put(named, tree, "n", "n", n_layers)
    tree.finish()
    got = leaves(tree.params["n"])
    assert set(got) == set(want)
    return max(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)
               for k in want)


def test_naive_v2_diff_remat_grads(monkeypatch):
    x, t, c = _inputs(8, 8, 1)
    jnet = JNaive(mel_channels=8, dim=16, num_layers=2, condition_dim=8,
                  use_mlp=False, remat=True)
    params, want = _jax_grads(jnet, x, t, c, seed=2)
    sd = {}
    _put_naive_v2_diff(sd, _Leaves({"denoise_fn": params}), "denoise_fn", "n", 2)
    calls = []
    layer = naive_v2_diff.conformer_layer
    monkeypatch.setattr(naive_v2_diff, "conformer_layer",
                        lambda *a: calls.append(1) or layer(*a))
    grads = {}
    for remat in (False, True):
        net = NaiveV2Diff(mel_channels=8, dim=16, condition_dim=8, num_layers=2,
                          remat=remat)
        load_state(net, {k[2:]: v for k, v in sd.items()})
        calls.clear()
        grads[remat] = _port_grads(net, x, t, c)
        # the kernel's wrapper: once per layer, and again in the backward
        assert len(calls) == (4 if remat else 2), (remat, len(calls))
    for n, g in grads[False].items():
        assert torch.equal(grads[True][n], g), n
    assert _held(grads[True], want, _put_naive_v2_diff, 2) <= GRAD_TOL


def test_wavenet_remat_grads():
    x, t, c = _inputs(8, 4, 3)
    jnet = JWaveNet(8, 3, 16, 4, remat=True)
    params, want = _jax_grads(jnet, x, t, c, seed=4)
    grads = {}
    for remat in (False, True):
        net = WaveNet(8, 3, 16, 4, remat=remat)
        load_state(net, wavenet_state_dict(params, 3))
        grads[remat] = _port_grads(net, x, t, c)
    for n, g in grads[False].items():
        assert torch.equal(grads[True][n], g), n
    assert _held(grads[True], want, _put_wavenet, 3) <= GRAD_TOL


@pytest.mark.parametrize("mtype", ["DiffusionFast", "Diffusion"])
def test_cascade_step_remat(mtype):
    """A whole train step with ``model.use_remat: true`` (the registry's
    ``remat=``) gives the loss terms, gradients and updated parameters of
    the step without it, exactly."""
    import copy

    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.train.state import create_train_state
    from ddsp_svc_tpu_torch.train.steps import (make_cascade_train_step,
                                                make_unit2mel_train_step, to_device)
    from torch_train_helpers import batch, port_mel_fn, tiny_config

    args = tiny_config(mtype)
    x = to_device(batch(mtype, b=2, seed=5), "cpu")
    out = {}
    for remat in (False, True):
        args["model"]["use_remat"] = remat
        # no zero-initialised output layer: every layer gets a gradient
        model = random_init_(build_model(args), torch.Generator().manual_seed(3))
        assert model.denoise_fn.remat is remat
        state = create_train_state(model, lr=1e-3)
        step = (make_unit2mel_train_step(100) if mtype == "Diffusion"
                else make_cascade_train_step(port_mel_fn(), k_step_max=100))
        metrics = step(state, copy.deepcopy(x), torch.Generator().manual_seed(9))
        out[remat] = (metrics, {n: p.grad.clone() for n, p in
                                model.named_parameters() if p.grad is not None},
                      copy.deepcopy(model.state_dict()))
    (m0, g0, p0), (m1, g1, p1) = out[False], out[True]
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}
    assert g0.keys() == g1.keys() and all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
