"""bf16 mixed-precision training parity (``test_torch_train_bf16*.py``): one
training step of a family built with ``dtype=bfloat16`` on both sides, from
the same parameters, batch and draws, and the gate it is held by.

The JAX side runs eagerly (every op rounds to bf16 where the model's ops
do). DiffusionFast and RectifiedFlow build their JAX cascade with
``trunk_pallas=True``, whose fused layer is the arithmetic class of B5: it
runs here in interpret mode, and its backward is the chain JAX's custom VJP
differentiates with the cotangent rounded to bf16 (the package's own VJP
refuses that bf16 cotangent of an f32 output; ``ops/cuda_conformer``).
Sins' JAX bank multiplies by amplitudes upsampled in bf16, as K4's
bf16-amplitude mode does, so Sins is held against the JAX model as it is;
the distance to a JAX bank patched to widen the amplitudes first (the
port's earlier f32 upsample, ``k4_class_bank``) is reported beside it.

The gate, per family, on the step:
  (i) every JAX module output that has a port counterpart has the same
      dtype: a stage left in float32, or a missing cast, fails it;
  (ii) the first bf16 layer of each stage (the synth's unit conv or embed,
      the denoiser's input projection) equals JAX's in at least
      ``FIRST_LAYER_SAME`` of its elements: the port rounds as JAX does,
      so only f32 sum orders flip an element, where a bias added before the
      conv's rounding (ROADMAP C(r)) changes a third of them;
  (iii) the loss terms within ``LOSS_TOL`` relative and the gradients,
      mapped to the JAX layout, within ``GRAD_TOL`` in L2 over every leaf
      relative to JAX's, per family: bf16's rounding flips, which differ
      between the two packages' sum orders and backward formulas, and
      PCmer's attention spreads over every frame. Each bound is about three
      times the largest distance three parameter seeds gave on the CPU.
"""
import re
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models import ddsp as jddsp
from ddsp_svc_tpu.models.registry import build_model as jax_build_model
from ddsp_svc_tpu.ops import losses as jlosses
from ddsp_svc_tpu.ops import pallas_conformer as jpc
from ddsp_svc_tpu_torch.io.jax_params import (load_state, model_state_dict,
                                              moments_params)
from ddsp_svc_tpu_torch.models import nn as pnn
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.ops import losses
from torch_train_helpers import (batch, jax_variables, jnp_tree, leaves,
                                 tiny_config, tt)

DDSP = ("Sins", "CombSub", "CombSubFast", "CombSubSuperFast")

FIRST_LAYER_SAME = 0.99
# (loss terms, gradients): the largest distance three parameter seeds (1-3,
# FAVOR+ projections drawn by JAX's own function) gave on the CPU is
# DiffusionFast 1.2e-5 / 2.6e-3, RectifiedFlow 6.3e-6 / 2.6e-3, Unit2Mel
# 3.5e-7 / 6.1e-3, Unit2Wav 8.3e-5 / 1.1e-2, CombSubSuperFast 2.5e-5 /
# 6.3e-3, CombSubFast 1.2e-4 / 1.8e-2, CombSub 1.3e-4 / 5.1e-2 and Sins
# 7.3e-5 / 5.3e-2 (the RSS loss term; PCmer's attention).
LOSS_TOL = {"DiffusionFast": 5e-5, "RectifiedFlow": 5e-5, "Diffusion": 2e-6,
            "DiffusionNew": 3e-4, "CombSubSuperFast": 1e-4, "CombSubFast": 4e-4,
            "CombSub": 4e-4, "Sins": 3e-4}
GRAD_TOL = {"DiffusionFast": 0.01, "RectifiedFlow": 0.01, "Diffusion": 0.02,
            "DiffusionNew": 0.035, "CombSubSuperFast": 0.02, "CombSubFast": 0.06,
            "CombSub": 0.15, "Sins": 0.16}
# the first bf16 layer of each stage: JAX intermediate -> port module
FIRST_LAYERS = {
    "ddsp": {"unit2ctrl/stack_conv0": "unit2ctrl.stack_conv0"},
    "DiffusionFast": {"ddsp_model/unit2ctrl/stack_conv0": "ddsp_model.unit2ctrl.stack_conv0",
                      "denoise_fn/input_projection": "denoise_fn.input_projection"},
    "RectifiedFlow": {"ddsp_model/unit2ctrl/stack_conv0": "ddsp_model.unit2ctrl.stack_conv0",
                      "velocity_fn/input_projection": "velocity_fn.input_projection"},
    "DiffusionNew": {"ddsp_model/unit2ctrl/stack_conv0": "ddsp_model.unit2ctrl.stack_conv0",
                     "denoise_fn/input_projection": "denoise_fn.input_projection"},
    "Diffusion": {"unit_embed": "unit_embed",
                  "denoise_fn/input_projection": "denoise_fn.input_projection"},
}
# the stage each family's "left in float32" fault leaves in f32
F32_STAGE = {"DiffusionFast": "denoise_fn", "RectifiedFlow": "velocity_fn",
             "Diffusion": "denoise_fn", "DiffusionNew": "denoise_fn"}


@partial(jax.custom_vjp)
def _fused_layer(x, cond, step_vec, weights):
    return jpc._fused_layer_impl(x, cond, step_vec, weights, 32, True, True)


def _fused_fwd(x, cond, step_vec, weights):
    return _fused_layer(x, cond, step_vec, weights), (x, cond, step_vec, weights)


def _fused_bwd(res, g):
    out, vjp = jax.vjp(jpc._stock_layer, *res)
    return vjp(g.astype(res[0].dtype).astype(out.dtype))


_fused_layer.defvjp(_fused_fwd, _fused_bwd)


def fused_conformer_layer(x, cond, step_vec, weights, **_):
    """JAX's fused layer in interpret mode, with the backward its custom
    VJP means to take on a bf16 x (see the module docstring)."""
    return _fused_layer(x, cond, step_vec, tuple(weights))


def k4_class_bank(phase, amplitudes, *args, **kwargs):
    """JAX's Sins bank on amplitudes widened to f32 before the upsample
    (K4's f32 mode on widened bf16 amplitudes)."""
    return _JAX_BANK(phase, amplitudes.astype(jnp.float32), *args, **kwargs)


_JAX_BANK = jddsp.sins_harmonic_bank


def linear_mel(wav):
    """The linear stand-in for the log-mel (test_torch_train_losses.py)."""
    return wav.reshape(wav.shape[0], -1, 512)[..., :128] * 4.0


def jax_model(args, trunk_pallas: bool):
    model = jax_build_model(args, dtype=jnp.bfloat16)
    return model.clone(trunk_pallas=True) if trunk_pallas else model


def _inputs(mtype, seed):
    x = batch(mtype, b=2, seed=3 + seed)
    if mtype in DDSP:
        x.pop("mel", None)
        x.pop("aug_shift", None)
    n = x["audio"].shape[1]
    rng = np.random.default_rng(4)
    uniform = mtype in ("Sins", "CombSub", "CombSubFast", "DiffusionNew")
    noise = (rng.uniform(-1, 1, (2, n)) if uniform
             else rng.standard_normal((2, n))).astype(np.float32)
    probe = rng.standard_normal((2, n)).astype(np.float32)
    return x, noise, probe


def jax_step(mtype, jmodel, variables, x, noise, probe, key):
    """(loss terms, gradient leaves, intermediates {path: dtype, array}) of
    JAX's eager step: a synth's loss is sum(signal x probe) with its RSS
    loss the term; a cascade's uses ``linear_mel``."""
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    key_noise, key_other = jax.random.split(key)
    noise = jnp.asarray(noise)

    def apply(params, buffers, **kw):
        v = {"params": params, **({"buffers": buffers} if buffers else {})}
        if mtype in DDSP:
            return jmodel.apply(v, xj["units"], xj["f0"], xj["volume"],
                                infer=False, noise=noise, **kw)
        kwargs = dict(gt_spec=xj["mel"], infer=False, key=key_other,
                      aug_shift=xj["aug_shift"])
        if mtype == "Diffusion":
            return jmodel.apply(v, xj["units"], xj["f0"], xj["volume"],
                                k_step=100, **kwargs, **kw)
        kwargs.update(mel_extract_fn=linear_mel, ddsp_noise=noise)
        if mtype == "RectifiedFlow":
            kwargs["t_start"] = 0.2
        else:
            kwargs["k_step"] = 100
        if mtype == "DiffusionNew":
            kwargs.pop("aug_shift")
        return jmodel.apply(v, xj["units"], xj["f0"], xj["volume"], **kwargs, **kw)

    def loss_fn(params, buffers):
        out = apply(params, buffers)
        if mtype in DDSP:
            out = out[0]
            rss = jlosses.RSSLoss(256, 2048, 4)(jax.lax.stop_gradient(out),
                                                xj["audio"], key_other)
            return jnp.sum(out * jnp.asarray(probe)), (rss,)
        if mtype == "Diffusion":
            return out, (out,)
        return out[0] + out[1], out

    params = jnp_tree(variables["params"])
    buffers = jnp_tree(variables["buffers"]) if "buffers" in variables else None
    (_, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, buffers)
    _, state = apply(params, buffers, capture_intermediates=True,
                     mutable=["intermediates"])
    inter = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif k == "__call__":
                out = v[0]
                if isinstance(out, jnp.ndarray):
                    inter[prefix.rstrip("/")] = out
    walk(jax.tree_util.tree_map(lambda a: a, dict(state["intermediates"])), "")
    return ([float(t) for t in terms],
            leaves(jax.tree_util.tree_map(np.asarray, grads)), inter)


def port_model(args, variables):
    port = build_model(args, dtype=torch.bfloat16)
    load_state(port, model_state_dict(args.model, variables["params"],
                                      variables.get("buffers")))
    return port


def port_draws(mtype, key, b, noise_shape):
    _, key_other = jax.random.split(key)
    if mtype in DDSP:
        return {"rss_idx": np.asarray(jax.random.randint(key_other, (4,), 0, 16))}
    key_t, key_n = jax.random.split(key_other)
    if mtype == "RectifiedFlow":
        t = 0.2 + 0.8 * jax.random.uniform(key_t, (b,), jnp.float32)
        return {"t": tt(jnp.clip(t, 1e-7, 1.0 - 1e-7)),
                "x_0": tt(jax.random.normal(key_n, noise_shape, jnp.float32))}
    return {"t": tt(jax.random.randint(key_t, (b,), 0, 100)),
            "noise": tt(jax.random.normal(key_n, noise_shape, jnp.float32))}


def port_step(mtype, port, x, noise, probe, key):
    """The port's step (as ``jax_step``): (loss terms, gradient leaves in
    the JAX layout, module outputs {name: tensor})."""
    xt = {k: tt(v) for k, v in x.items()}
    draws = port_draws(mtype, key, 2, (2, x["units"].shape[1], 128))
    outs = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, name=name: outs.setdefault(name, o))
        for name, m in port.named_modules()]
    try:
        port.zero_grad(set_to_none=True)
        if mtype in DDSP:
            signal, _ = port(xt["units"], xt["f0"], xt["volume"], noise=tt(noise))
            rss = losses.RSSLoss(256, 2048, 4)(signal.detach(), xt["audio"],
                                               draws["rss_idx"])
            loss, terms = torch.sum(signal * tt(probe)), (rss,)
        elif mtype == "Diffusion":
            loss = port.loss(xt["units"], xt["f0"], xt["volume"], xt["mel"],
                             aug_shift=xt["aug_shift"], k_step=100, **draws)
            terms = (loss,)
        else:
            kwargs = dict(mel_extract_fn=linear_mel, ddsp_noise=tt(noise), **draws)
            if mtype == "RectifiedFlow":
                kwargs["t_start"] = 0.2
            else:
                kwargs["k_step"] = 100
            if mtype != "DiffusionNew":
                kwargs["aug_shift"] = xt["aug_shift"]
            terms = port.loss(xt["units"], xt["f0"], xt["volume"], xt["mel"],
                              **kwargs)
            loss = terms[0] + terms[1]
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    grads = {n: p.grad for n, p in port.named_parameters()}
    args_model = port._args_model
    return ([float(t.detach()) for t in terms],
            leaves(moments_params(args_model, grads)), outs)


def _port_name(path: str) -> str:
    """A flax module path -> the port's module name, where one exists."""
    return re.sub(r"layer_(\d+)", r"layers.\1", path).replace("/", ".")


def distance(got, want) -> tuple:
    """(the loss terms' largest relative difference, the gradients' L2
    difference over every leaf relative to ``want``'s) of two steps'
    (terms, gradient leaves)."""
    (gterms, ggrads), (wterms, wgrads) = got[:2], want[:2]
    loss = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(gterms, wterms))
    assert set(ggrads) == set(wgrads)
    num = sum(float(((ggrads[k] - wgrads[k]) ** 2).sum()) for k in wgrads)
    den = sum(float((wgrads[k] ** 2).sum()) for k in wgrads)
    return loss, (num / den) ** 0.5


def gate(mtype, jres, pres) -> dict:
    """The bf16 step gate (module docstring): a dict of its parts and
    ``ok``."""
    jterms, jgrads, jinter = jres
    pterms, pgrads, pouts = pres
    dtypes, matched = [], 0
    for path, arr in jinter.items():
        out = pouts.get(_port_name(path))
        if isinstance(out, torch.Tensor) and tuple(out.shape) == arr.shape:
            matched += 1
            if str(out.dtype).replace("torch.", "") != str(arr.dtype):
                dtypes.append(f"{path}: port {out.dtype}, JAX {arr.dtype}")
    first = {}
    family = "ddsp" if mtype in DDSP else mtype
    for jpath, pname in FIRST_LAYERS[family].items():
        want = np.asarray(jinter[jpath].astype(jnp.float32))
        got = pouts[pname].detach().float().numpy()
        first[pname] = float((got == want).mean())
    loss, grad = distance((pterms, pgrads), (jterms, jgrads))
    ok = (not dtypes and matched >= 5
          and min(first.values()) >= FIRST_LAYER_SAME
          and loss <= LOSS_TOL[mtype] and grad <= GRAD_TOL[mtype])
    return dict(ok=ok, dtypes=dtypes[:5], matched=matched, first=first,
                loss=loss, grad=grad)


def setup(mtype, seed: int = 1, trunk_pallas: bool = True):
    """(args, JAX bf16 model, variables, port bf16 model, inputs, key)."""
    args = tiny_config(mtype)
    variables = jax_variables(args, jax_build_model(args), seed, shapes_only=True)
    pallas = trunk_pallas and mtype in ("DiffusionFast", "RectifiedFlow")
    jmodel = jax_model(args, pallas)
    port = port_model(args, variables)
    port._args_model = args.model
    return args, jmodel, variables, port, _inputs(mtype, seed), jax.random.PRNGKey(11)


def bias_before_rounding(monkeypatch):
    """Planted fault: every Conv1d adds its bias inside the bf16 conv (one
    rounding), where JAX rounds the conv and then adds the bias."""
    def forward(self, x, dtype=None):
        dtype = dtype or self.compute_dtype or x.dtype
        w = self.folded_weight()
        b = None if self.bias is None else self.bias.to(dtype)
        y = F.conv1d(x.transpose(1, 2).to(dtype), w.to(dtype), b, self.stride,
                     self.padding, self.dilation, self.groups)
        return y.transpose(1, 2)
    monkeypatch.setattr(pnn.Conv1d, "forward", forward)


def f32_stage(mtype, port):
    """Planted fault: the family's stage left in float32 (the trunk or the
    WaveNet of a cascade, Unit2Control of a synth)."""
    stage = F32_STAGE.get(mtype, "unit2ctrl")
    pnn.set_compute_dtype(port.get_submodule(stage), torch.float32)
