"""The training losses and each family's training forward against the JAX
package: ``sss_loss`` at every lattice size, ``RSSLoss`` with injected
indices and the three mel metrics at 1e-5 relative; the loss of one
training step of Sins, CombSubSuperFast, DiffusionFast, RectifiedFlow
(``l2_lognorm``), Unit2Mel and Unit2Wav at 1e-5 relative and every
parameter's gradient, weight norm's v and g included, at 1e-5 x max|grad|
of its leaf, mapped to the JAX layout by the inverse converter; the reflow
loss types at the module level; and dropout, which the JAX models declare
but never apply.

Every draw is the same array on both sides: the synth noise through the
JAX models' ``noise=`` / ``ddsp_noise=`` hooks, and the draws JAX makes
inside (the diffusion t and noise, the reflow t and x_0, the RSS lattice
indices) recomputed here from the key the JAX step splits and handed to the
port. Both sides run dropout off (JAX ``deterministic=True``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.ops import losses as jlosses
from ddsp_svc_tpu_torch.io.jax_params import moments_params
from ddsp_svc_tpu_torch.ops import losses
from torch_train_helpers import (batch, jax_mel_fn, jnp_tree, leaves, pair,
                                 port_mel_fn, tt)


def _rel(got, want) -> float:
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    return float(abs(got - float(want)) / max(abs(float(want)), 1e-30))


def test_sss_loss_every_lattice_size():
    rng = np.random.default_rng(0)
    a = (0.3 * rng.standard_normal((2, 8192))).astype(np.float32)
    b = (0.3 * rng.standard_normal((2, 8192))).astype(np.float32)
    sizes = jlosses._default_lattice(256, 2048)
    assert losses.default_lattice(256, 2048) == sizes and len(sizes) == 16
    for n in sizes:
        want = jlosses.sss_loss(jnp.asarray(a), jnp.asarray(b), n)
        assert _rel(losses.sss_loss(tt(a), tt(b), n), want) < 1e-5, n


def test_rss_loss_with_injected_indices():
    rng = np.random.default_rng(1)
    a = (0.3 * rng.standard_normal((2, 8192))).astype(np.float32)
    b = (0.3 * rng.standard_normal((2, 8192))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    rss = jlosses.RSSLoss(256, 2048, 4)
    idx = np.asarray(jax.random.randint(key, (4,), 0, len(rss.sizes)))
    want = rss(jnp.asarray(a), jnp.asarray(b), key)
    got = losses.RSSLoss(256, 2048, 4)(tt(a), tt(b), idx)
    assert _rel(got, want) < 1e-5
    assert _rel(losses.rss_loss(tt(a), tt(b), idx),
                jlosses.rss_loss(jnp.asarray(a), jnp.asarray(b), key)) < 1e-5


def test_mel_metrics():
    rng = np.random.default_rng(2)
    gt = (rng.standard_normal((1, 40, 128)) - 4).astype(np.float32)
    pred = gt + 0.3 * rng.standard_normal(gt.shape).astype(np.float32)
    for name in ("mel_snr", "mel_si_snr", "mel_psnr"):
        want = getattr(jlosses, name)(jnp.asarray(gt), jnp.asarray(pred))
        assert _rel(getattr(losses, name)(tt(gt), tt(pred)), want) < 1e-5, name


def linear_mel(wav):
    """A well-conditioned stand-in for the log-mel: (B, T * 512) audio ->
    (B, T, 128), each frame's first 128 samples (either framework)."""
    return wav.reshape(wav.shape[0], -1, 512)[..., :128] * 4.0


def _jax_loss(mtype, jmodel, x, key, noise, probe):
    """The JAX step's loss (train/steps.py loss_fn) with dropout off, the
    synth noise injected and ``linear_mel`` -> (params -> (loss, terms)); a
    DDSP synth's loss is sum(signal x probe), its RSS loss the term."""
    key_noise, key_other = jax.random.split(key)
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    if mtype in ("Sins", "CombSubSuperFast"):
        rss = jlosses.RSSLoss(256, 2048, 4)

        def f(params, buffers):
            variables = {"params": params, **({"buffers": buffers} if buffers else {})}
            signal, _, _ = jmodel.apply(variables, xj["units"], xj["f0"],
                                        xj["volume"], infer=False,
                                        deterministic=True, noise=noise)
            rss_loss = rss(jax.lax.stop_gradient(signal), xj["audio"], key_other)
            return jnp.sum(signal * probe), (rss_loss,)
        return f
    kwargs = dict(gt_spec=xj["mel"], infer=False, key=key_other,
                  deterministic=True, aug_shift=xj["aug_shift"])
    if mtype == "Diffusion":
        def f(params, buffers):
            loss = jmodel.apply({"params": params}, xj["units"], xj["f0"],
                                xj["volume"], k_step=100, **kwargs)
            return loss, (loss,)
        return f
    kwargs.update(mel_extract_fn=linear_mel, ddsp_noise=noise)
    if mtype == "RectifiedFlow":
        kwargs["t_start"] = 0.2
    else:
        kwargs["k_step"] = 100
    if mtype == "DiffusionNew":
        kwargs.pop("aug_shift")

    def f(params, buffers):
        variables = {"params": params, **({"buffers": buffers} if buffers else {})}
        ddsp_loss, diff_loss = jmodel.apply(variables, xj["units"], xj["f0"],
                                            xj["volume"], **kwargs)
        return ddsp_loss + diff_loss, (ddsp_loss, diff_loss)
    return f


def _port_draws(mtype, key, b, noise_shape):
    """What the JAX model draws inside, from the same key, for the port."""
    _, key_other = jax.random.split(key)
    if mtype in ("Sins", "CombSubSuperFast"):
        return {"rss_idx": np.asarray(jax.random.randint(key_other, (4,), 0, 16))}
    key_t, key_n = jax.random.split(key_other)
    if mtype == "RectifiedFlow":
        t = 0.2 + 0.8 * jax.random.uniform(key_t, (b,), jnp.float32)
        return {"t": tt(jnp.clip(t, 1e-7, 1.0 - 1e-7)),
                "x_0": tt(jax.random.normal(key_n, noise_shape, jnp.float32))}
    return {"t": tt(jax.random.randint(key_t, (b,), 0, 100)),
            "noise": tt(jax.random.normal(key_n, noise_shape, jnp.float32))}


def _port_loss(mtype, port, x, draws, noise, probe):
    xt = {k: tt(v) for k, v in x.items()}
    if mtype in ("Sins", "CombSubSuperFast"):
        signal, _ = port(xt["units"], xt["f0"], xt["volume"], noise=tt(noise))
        rss_loss = losses.RSSLoss(256, 2048, 4)(signal.detach(), xt["audio"],
                                               draws["rss_idx"])
        return torch.sum(signal * tt(probe)), (rss_loss,)
    if mtype == "Diffusion":
        loss = port.loss(xt["units"], xt["f0"], xt["volume"], xt["mel"],
                         aug_shift=xt["aug_shift"], k_step=100, **draws)
        return loss, (loss,)
    kwargs = dict(mel_extract_fn=linear_mel, ddsp_noise=tt(noise), **draws)
    if mtype == "RectifiedFlow":
        kwargs["t_start"] = 0.2
    else:
        kwargs["k_step"] = 100
    if mtype != "DiffusionNew":
        kwargs["aug_shift"] = xt["aug_shift"]
    ddsp_loss, diff_loss = port.loss(xt["units"], xt["f0"], xt["volume"],
                                     xt["mel"], **kwargs)
    return ddsp_loss + diff_loss, (ddsp_loss, diff_loss)


# Two losses have ill-conditioned gradients, whatever the model: the RSS
# loss's log term weights each bin by 1 / |S| and the log-mel each mel bin
# by 1 / mel, so near-zero bins carry the two FFTs' rounding into the
# gradient. On one signal array the RSS gradients of the two packages differ
# by up to 1e-4 x max|grad|. So a step's parameter gradients are held at
# GRAD_TOL with those two stages replaced by linear ones -- a DDSP synth
# under sum(signal x probe) (its RSS loss value still compared), a cascade
# with ``linear_mel`` as its mel extractor -- which holds every module's own
# backward (the controls, the weight-normed output layer, the filters, K1's
# exciter, K4's bank, the trunks, the losses of diffusion and reflow), and
# the two stages' own gradients are held by the tests that follow, the RSS
# loss's at RSS_GRAD_TOL. The JAX side runs eagerly: jitted XLA reorders
# sums, which moves deep leaves' gradients by up to 7e-5 (ROADMAP C(h)).
GRAD_TOL = 1e-5
RSS_GRAD_TOL = 3e-4
MEL_GRAD_TOL = 1e-5
# The step MLP's first layer sees sin / cos of t x w_k, with t up to 1000
# in the reflow (1000 t): the two packages' exp rounds w_k by an ulp, which
# moves the argument by up to 1000 x 6e-8, and its gradient by ~1e-5.
STEP_EMB_GRAD_TOL = 5e-5


def _grad_errors(args, port, jgrads):
    """max over leaves of |port - JAX| / max|JAX| of the leaf, the step
    MLP's first layer divided by STEP_EMB_GRAD_TOL / GRAD_TOL."""
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = leaves(moments_params(args.model, grads))
    want = leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want)
    if args.model.type != "Diffusion":  # the synth's weight-normed dense_out
        assert any(k.endswith("kernel_v") for k in got) and any(
            k.endswith("kernel_g") for k in got)

    def err(k):
        e = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)
        return e * GRAD_TOL / STEP_EMB_GRAD_TOL if "diff_emb_0/" in k else e
    return max((err(k), k) for k in want)


@pytest.mark.parametrize("mtype", ["Sins", "CombSubSuperFast", "DiffusionFast",
                                   "RectifiedFlow", "Diffusion", "DiffusionNew"])
def test_training_forward_and_gradients(mtype):
    """Loss terms at 1e-5 relative; every leaf's gradient at 1e-5 x
    max|grad| of the leaf under the probe loss (DDSP) or with the linear
    mel stand-in (cascades). The log-mel's and the RSS loss's own gradients
    are held by the two tests below."""
    args, jmodel, variables, port = pair(mtype)
    x = batch(mtype, b=2, seed=3)
    key = jax.random.PRNGKey(11)
    noise_len = x["audio"].shape[1]
    rng = np.random.default_rng(4)
    if mtype in ("Sins", "DiffusionNew"):
        noise = rng.uniform(-1, 1, (2, noise_len)).astype(np.float32)
    else:
        noise = rng.standard_normal((2, noise_len)).astype(np.float32)
    w = rng.standard_normal((2, noise_len)).astype(np.float32)
    fn = _jax_loss(mtype, jmodel, x, key, jnp.asarray(noise), jnp.asarray(w))
    (jloss, jterms), jgrads = jax.value_and_grad(fn, has_aux=True)(
        jnp_tree(variables["params"]),
        jnp_tree(variables["buffers"]) if "buffers" in variables else None)

    port.train()
    draws = _port_draws(mtype, key, 2, (2, x["units"].shape[1], 128))
    loss, terms = _port_loss(mtype, port, x, draws, noise, w)
    for got, want in zip(terms, jterms):
        assert _rel(got.detach(), want) < 1e-5, (mtype, float(got), float(want))
    loss.backward()
    worst = _grad_errors(args, port, jgrads)
    assert worst[0] <= GRAD_TOL, (mtype, worst)


def test_rss_gradient_conditioning():
    """The measurement behind RSS_GRAD_TOL: on one signal array the RSS
    gradients of the two packages differ by more than 1e-5 x max|grad| and
    by less than RSS_GRAD_TOL."""
    rng = np.random.default_rng(6)
    sig = (0.3 * rng.standard_normal((2, 8192))).astype(np.float32)
    ref = (0.3 * rng.standard_normal((2, 8192))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    idx = np.asarray(jax.random.randint(key, (4,), 0, 16))
    want = np.asarray(jax.grad(lambda s: jlosses.RSSLoss(256, 2048, 4)(
        s, jnp.asarray(ref), key))(jnp.asarray(sig)))
    st = tt(sig).requires_grad_()
    losses.RSSLoss(256, 2048, 4)(st, tt(ref), idx).backward()
    err = np.abs(st.grad.numpy() - want).max() / np.abs(want).max()
    assert err < RSS_GRAD_TOL, err


def test_log_mel_gradient():
    """The training mel (the vocoder's log-mel) and its gradient on one
    audio array: the mel at 1e-5 x max|mel|, the gradient of sum(mel x
    probe) at MEL_GRAD_TOL x max|grad| (its 1 / mel weight, above)."""
    rng = np.random.default_rng(8)
    audio = (0.3 * rng.standard_normal((2, 16 * 512))).astype(np.float32)
    probe = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jmel = jax_mel_fn()
    want_mel, vjp = jax.vjp(jmel, jnp.asarray(audio))
    want = np.asarray(vjp(jnp.asarray(probe))[0])
    at = tt(audio).requires_grad_()
    mel = port_mel_fn()(at)
    assert mel.shape == want_mel.shape
    assert np.abs(mel.detach().numpy() - np.asarray(want_mel)).max() <= \
        1e-5 * np.abs(np.asarray(want_mel)).max()
    (mel * tt(probe)).sum().backward()
    err = np.abs(at.grad.numpy() - want).max() / np.abs(want).max()
    print("mel grad err", err)
    assert err <= MEL_GRAD_TOL, err


@pytest.mark.parametrize("loss_type", ["l2_lognorm", "l2", "l1"])
def test_reflow_loss_types(loss_type):
    """RectifiedFlow's training loss by type at the module level, with a
    NaiveV2Diff velocity net, t and x_0 as JAX draws them."""
    from ddsp_svc_tpu.models.naive_v2_diff import NaiveV2Diff as JNaive
    from ddsp_svc_tpu.models.reflow import RectifiedFlow as JFlow
    from ddsp_svc_tpu_torch.io.jax_params import _Leaves, _put_naive_v2_diff
    from ddsp_svc_tpu_torch.io.jax_params import load_state
    from ddsp_svc_tpu_torch.models.naive_v2_diff import NaiveV2Diff
    from ddsp_svc_tpu_torch.models.reflow import RectifiedFlow
    from torch_helpers import randomize_tree

    rng = np.random.default_rng(5)
    cond = rng.standard_normal((2, 12, 16)).astype(np.float32)
    gt = (rng.standard_normal((2, 12, 16)) - 4).astype(np.float32)
    net = JNaive(mel_channels=16, dim=32, num_layers=2, condition_dim=16,
                 use_mlp=False, name="velocity_fn")
    flow = JFlow(net, out_dims=16)
    key = jax.random.PRNGKey(3)
    params = randomize_tree(flow.init({"params": jax.random.PRNGKey(0)}, cond,
                                      gt_spec=gt, infer=False, key=key,
                                      t_start=0.3)["params"], seed=2)
    want = flow.apply({"params": params}, cond, gt_spec=gt, infer=False,
                      key=key, t_start=0.3, loss_type=loss_type)
    key_t, key_n = jax.random.split(key)
    t = jnp.clip(0.3 + 0.7 * jax.random.uniform(key_t, (2,), jnp.float32),
                 1e-7, 1 - 1e-7)
    x0 = jax.random.normal(key_n, gt.shape, jnp.float32)
    port = NaiveV2Diff(mel_channels=16, dim=32, condition_dim=16, num_layers=2)
    sd = {}
    _put_naive_v2_diff(sd, _Leaves(params), "velocity_fn", "n", 2)
    load_state(port, {k[2:]: v for k, v in sd.items()})
    got = RectifiedFlow(16).loss(lambda x, tv: port(x, tv, tt(cond)), tt(gt),
                                 0.3, tt(t), tt(x0), loss_type)
    assert _rel(got, want) < 1e-5


def test_no_dropout_fires():
    """JAX declares PCmer's residual and attention dropout (0.1) and the
    naive encoder's attention dropout (0.1) but applies none: the JAX synths
    give the same signal with deterministic=False under a dropout key as
    with deterministic=True. The port holds no Dropout module, and its
    train() and eval() forwards are the same."""
    for mtype in ("Sins", "CombSubSuperFast"):
        args, jmodel, variables, port = pair(mtype)
        x = {k: jnp.asarray(v) for k, v in batch(mtype, b=1).items()}
        noise = jnp.zeros((1, x["audio"].shape[1]), jnp.float32)
        on = jmodel.apply(variables, x["units"], x["f0"], x["volume"],
                          deterministic=False, noise=noise,
                          rngs={"dropout": jax.random.PRNGKey(5)})[0]
        off = jmodel.apply(variables, x["units"], x["f0"], x["volume"],
                           deterministic=True, noise=noise)[0]
        np.testing.assert_array_equal(np.asarray(on), np.asarray(off))
        assert not any(isinstance(m, torch.nn.Dropout) for m in port.modules())
        xt = {k: tt(np.asarray(v)) for k, v in x.items()}
        with torch.no_grad():
            a = port.train()(xt["units"], xt["f0"], xt["volume"],
                             noise=tt(np.asarray(noise)))[0]
            b = port.eval()(xt["units"], xt["f0"], xt["volume"],
                            noise=tt(np.asarray(noise)))[0]
        assert torch.equal(a, b)
