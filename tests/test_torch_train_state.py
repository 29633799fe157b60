"""The train state against optax (ddsp_svc_tpu/train/state.py): AdamW with
decoupled weight decay and the StepLR schedule over five updates on the
same gradients, a resume at step 3 with and without the optimizer state,
the optax state <-> AdamW state maps, and the random init's distributions
per leaf against the JAX init's.

Tolerance of the updates: optax applies the decay inside the update, p -
lr (m^ / (sqrt(v^) + eps) + wd p), torch first, p (1 - lr wd) - lr m^ /
(sqrt(v^) + eps); equal in exact arithmetic, they round differently, by a
few f32 ulps of p per step. After five steps the parameters agree to 1e-6
x max(1, |p|) (measured: 2.4e-7)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from ddsp_svc_tpu.train.state import create_train_state as jax_train_state
from ddsp_svc_tpu_torch.io.jax_params import moments_params, moments_state_dict
from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.train.state import (create_train_state, opt_state_to_optax,
                                            param_count, restore_opt_state)
from torch_train_helpers import batch, jax_mel_fn, leaves, pair, tiny_config

LR, WD, DECAY, GAMMA = 1e-2, 0.05, 2, 0.5
TOL = 1e-6


def _grads(params, n, seed=0):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
        for _ in range(n)]


def _set_grads(model, args, grads):
    named = moments_state_dict(args.model, grads)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.array(named[name], np.float32))


def _check(model, args, jparams, tol=TOL):
    got = leaves(moments_params(args.model, {n: p.detach() for n, p in
                                             model.named_parameters()}))
    want = leaves(jax.tree_util.tree_map(np.asarray, jparams))
    for k in want:
        err = np.abs(got[k] - want[k]) / np.maximum(1.0, np.abs(want[k]))
        assert err.max() <= tol, (k, err.max())


class _Model:
    """The minimal flax module interface the JAX train state needs."""
    apply = None


def _setup():
    args, _, variables, port = pair("CombSubSuperFast")
    return args, variables["params"], port


def test_five_updates_and_the_schedule():
    args, params, port = _setup()
    jstate = jax_train_state(_Model(), params, lr=LR, weight_decay=WD,
                             decay_step=DECAY, gamma=GAMMA)
    state = create_train_state(port, lr=LR, weight_decay=WD, decay_step=DECAY,
                               gamma=GAMMA)
    for k, g in enumerate(_grads(params, 5)):
        assert state.lr() == pytest.approx(LR * GAMMA ** (k // DECAY), rel=1e-7)
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, g))
        _set_grads(port, args, g)
        state.apply_gradients()
        assert state.step == int(jstate.step) == k + 1
        _check(port, args, jstate.params)


@pytest.mark.parametrize("with_opt_state", [False, True])
def test_resume_at_step_3(with_opt_state):
    """Resumed at step 3, the rate continues at lr * gamma^(3 // 2) and the
    next updates match JAX's resumed state: fresh moments with every count
    fast-forwarded, or the saved optimizer state restored."""
    args, params, port = _setup()
    grads = _grads(params, 5, seed=1)
    jstate = jax_train_state(_Model(), params, lr=LR, weight_decay=WD,
                             decay_step=DECAY, gamma=GAMMA)
    for g in grads[:3]:
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, g))
    from ddsp_svc_tpu_torch.io.jax_params import load_state, model_state_dict
    load_state(port, model_state_dict(args.model, jax.tree_util.tree_map(
        np.asarray, jstate.params), None))
    jresumed = jax_train_state(_Model(), jstate.params, lr=LR, weight_decay=WD,
                               decay_step=DECAY, gamma=GAMMA, start_step=3)
    state = create_train_state(port, lr=LR, weight_decay=WD, decay_step=DECAY,
                               gamma=GAMMA, start_step=3)
    if with_opt_state:
        saved = serialization.to_state_dict(jax.tree_util.tree_map(
            np.asarray, jstate.opt_state))
        jresumed = jresumed.replace(opt_state=jstate.opt_state)
        assert restore_opt_state(state, args.model, saved)
    assert state.lr() == pytest.approx(LR * GAMMA, rel=1e-7)
    for g in grads[3:]:
        jresumed = jresumed.apply_gradients(jax.tree_util.tree_map(jnp.asarray, g))
        _set_grads(port, args, g)
        state.apply_gradients()
        _check(port, args, jresumed.params)
    assert state.step == 5


def test_optax_state_round_trip():
    """AdamW's state after three updates, written in optax's chain form,
    equals JAX's own state dict (counts, mu, nu by name and layout); read
    back, it restores AdamW exactly; a tree of another model is refused
    without touching the state."""
    args, params, port = _setup()
    jstate = jax_train_state(_Model(), params, lr=LR, weight_decay=WD,
                             decay_step=DECAY, gamma=GAMMA)
    state = create_train_state(port, lr=LR, weight_decay=WD, decay_step=DECAY,
                               gamma=GAMMA)
    for g in _grads(params, 3, seed=2):
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, g))
        _set_grads(port, args, g)
        state.apply_gradients()
    want = leaves(serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state)))
    got = leaves(opt_state_to_optax(state, args.model))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        # torch updates the moments by lerp, optax by a weighted sum: an
        # ulp or so apart
        assert np.abs(got[k] - want[k]).max() <= 1e-6 * max(
            np.abs(want[k]).max(), 1e-30), k
    before = {p: {k: v.clone() for k, v in s.items()}
              for p, s in state.optimizer.state.items()}
    state2 = create_train_state(port, lr=LR)
    assert restore_opt_state(state2, args.model, opt_state_to_optax(state, args.model))
    for p in port.parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state2.optimizer.state[p][k], before[p][k])
        assert float(state2.optimizer.state[p]["step"]) == 3.0
    other = pair("Sins")[0]
    assert not restore_opt_state(state, other.model,
                                 opt_state_to_optax(state, args.model))
    for p in port.parameters():
        assert torch.equal(state.optimizer.state[p]["exp_avg"], before[p]["exp_avg"])


@pytest.mark.parametrize("mtype", ["DiffusionFast", "Sins"])
def test_init_statistics_per_leaf(mtype):
    """random_init_ draws every leaf from the JAX init's distribution:
    kernels and biases U(+-1/sqrt(fan_in)) (JAX ``_kaiming_uniform_torch``),
    weight norm's g = ||v||, norms at ones and zeros, the denoiser's output
    projection at zero (``training=True``), FAVOR+ projections
    with rows of norm ~sqrt(64). Per leaf: the same bound, and means and
    spreads within sampling error of each other."""
    from ddsp_svc_tpu.models.registry import build_model as jax_build_model

    args = tiny_config(mtype)
    jmodel = jax_build_model(args)
    x = batch(mtype, b=1)
    kwargs = {}
    if mtype == "DiffusionFast":
        kwargs = dict(gt_spec=x["mel"], infer=False, key=jax.random.PRNGKey(2),
                      mel_extract_fn=jax_mel_fn(), k_step=100,
                      aug_shift=x["aug_shift"])
    # jitted: one compile of the init's forward (eagerly, every op apart)
    jvars = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(3),
                                         "noise": jax.random.PRNGKey(4)},
                                        x["units"], x["f0"], x["volume"], **kwargs))()
    want = leaves(jax.tree_util.tree_map(np.asarray, jvars["params"]))
    port = random_init_(build_model(args), torch.Generator().manual_seed(5),
                        training=True)
    assert param_count(port) == sum(v.size for v in want.values())
    got = leaves(moments_params(args.model, {n: p.detach() for n, p in
                                             port.named_parameters()}))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("kernel_g"):
            v = k[:-1] + "v"
            for tree in (got, want):
                np.testing.assert_allclose(tree[k], np.linalg.norm(tree[v], axis=0),
                                           rtol=1e-5, err_msg=k)
        elif k.endswith("scale") or (k.endswith("bias") and "norm" in k.split("/")[-2].lower()):
            np.testing.assert_array_equal(g, w)
        elif not w.any():  # the denoisers' output projections
            assert not g.any(), k
        elif k.endswith("embedding"):
            for v in (g, w):  # flax Embed: N(0, 1 / features)
                assert abs(v.std() * np.sqrt(v.shape[1]) - 1.0) < 0.2, k
        else:
            scope = k.rsplit("/", 1)[0]
            kernel = want.get(f"{scope}/kernel", want.get(f"{scope}/kernel_v"))
            bound = 1.0 / np.sqrt(np.prod(kernel.shape[:-1]))
            for v in (g, w):
                assert np.abs(v).max() <= bound * (1 + 1e-6), (k, bound)
                if v.size >= 512:
                    assert abs(v.std() * np.sqrt(3.0) / bound - 1.0) < 0.1, k
                    assert abs(v.mean()) < 0.1 * bound, k
    if mtype == "Sins":
        jbuf = leaves(jax.tree_util.tree_map(np.asarray, jvars["buffers"]))
        for name, buf in port.named_buffers():
            if name.endswith("projection_matrix"):
                jp = jbuf[name.replace(".", "/").replace("decoder/layers/",
                                                         "decoder/layer_")]
                assert buf.shape == jp.shape
                rows = buf.norm(dim=1).mean().item()
                assert abs(rows / np.linalg.norm(jp, axis=1).mean() - 1) < 0.15
