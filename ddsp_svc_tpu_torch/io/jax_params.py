"""JAX param trees <-> the port's state dicts.

Reads the JAX package's params (a nested dict of numpy arrays, as
``flax`` keeps them) or its checkpoint file (``train/checkpoint.py``: one
flax msgpack payload, decoded by the port's own codec,
``io/msgpack_codec.py``), and for the model families writes the port's state
dict back as a JAX param tree (``model_params``), so that a checkpoint the
port trains is one the JAX package reads.

A model's ``buffers`` tree (the FAVOR+ projections of a PCmer decoder)
maps to the port's buffers the same way, leaf by leaf.

Layout rules (the inverse of the torch->flax converters): Dense kernel
(in, out) -> Linear weight (out, in); Conv1d kernel (k, in, out) -> (out,
in, k); ConvTranspose1d kernel (k, in, out) -> (in, out, k), no flip. The
models' weight-normed Dense (``dense_out``) keeps v and g apart
(``models/nn.WNLinear``); the vocoder's weight norm is folded as the JAX
modules fold it, with the +1e-12: Conv1d / Dense normalise over every axis
but the output one; ConvTranspose1d normalises per *input* channel. Every
leaf must map, and every port parameter must be set, or a ``KeyError`` names
the leftovers.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

from . import msgpack_codec


def read_msgpack(path: str) -> dict:
    """A flax msgpack file (a JAX checkpoint or vocoder payload) -> tree.
    (flax splits leaves above 1 GiB into chunks; no leaf of these models
    comes near that, and such a tree fails the leaf mapping by name.)"""
    with open(path, "rb") as f:
        return msgpack_codec.unpackb(f.read())


class _Leaves:
    """The JAX tree flattened to 'a/b/c' paths; ``take`` pops a leaf so the
    leftovers can be reported."""

    def __init__(self, params: dict):
        self.leaves: dict[str, np.ndarray] = {}
        self._flatten(params, "")

    def _flatten(self, node, prefix):
        for k, v in node.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                self._flatten(v, path + "/")
            else:
                self.leaves[path] = np.asarray(v, dtype=np.float32)

    def has(self, path: str) -> bool:
        return path in self.leaves

    def take(self, path: str) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"JAX param {path!r} missing")
        return self.leaves.pop(path)

    def present(self, sd: dict, jax_path: str, port_key: str) -> bool:
        """Whether an optional part is there: read from the JAX side."""
        return jax_path in self.leaves

    def finish(self):
        if self.leaves:
            raise KeyError("JAX params left unmapped: " + ", ".join(sorted(self.leaves)))


class _ToJax:
    """The other direction: a port state dict -> JAX ``params`` and
    ``buffers`` trees, written by the same mapping functions. ``present``
    reads optional parts from the port side; ``finish`` raises on a port
    entry no rule took."""

    def __init__(self, sd: dict, with_buffers: bool = True):
        self.sd = sd
        self.with_buffers = with_buffers
        self.params: dict = {}
        self.buffers: dict = {}
        self.used: set = set()

    def present(self, sd: dict, jax_path: str, port_key: str) -> bool:
        return port_key in sd

    def get(self, key: str) -> np.ndarray:
        self.used.add(key)
        v = self.sd[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.ascontiguousarray(np.asarray(v, dtype=np.float32))

    def put(self, path: str, value: np.ndarray, tree: dict | None = None) -> None:
        node = self.params if tree is None else tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)

    def finish(self):
        left = sorted(set(self.sd) - self.used)
        if left:
            raise KeyError("port state left unmapped: " + ", ".join(left))


def _wn_fold(v: np.ndarray, g: np.ndarray, axes: tuple, shape_g) -> np.ndarray:
    norm = np.sqrt(np.sum(v * v, axis=axes, dtype=np.float32))
    return v * (g / (norm + np.float32(1e-12))).reshape(shape_g)


def _kernel(tree: _Leaves, scope: str) -> np.ndarray:
    """The (folded) flax kernel of ``scope``, JAX layout."""
    if tree.has(f"{scope}/kernel_v"):
        v = tree.take(f"{scope}/kernel_v")
        g = tree.take(f"{scope}/kernel_g")
        return _wn_fold(v, g, tuple(range(v.ndim - 1)), (1,) * (v.ndim - 1) + (-1,))
    return tree.take(f"{scope}/kernel")


def _put_bias(sd, tree, scope, name):
    if isinstance(tree, _ToJax):
        if f"{name}.bias" in sd:
            tree.put(f"{scope}/bias", tree.get(f"{name}.bias"))
    elif tree.has(f"{scope}/bias"):
        sd[f"{name}.bias"] = tree.take(f"{scope}/bias")


def _put_dense(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    if isinstance(tree, _ToJax):
        tree.put(f"{scope}/kernel", tree.get(f"{name}.weight").T)
    else:
        sd[f"{name}.weight"] = np.ascontiguousarray(_kernel(tree, scope).T)
    _put_bias(sd, tree, scope, name)


def _put_wn_dense(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    """A weight-normed Dense kept as v (transposed) and g (``WNLinear``)."""
    if isinstance(tree, _ToJax):
        tree.put(f"{scope}/kernel_v", tree.get(f"{name}.weight_v").T)
        tree.put(f"{scope}/kernel_g", tree.get(f"{name}.weight_g"))
    else:
        sd[f"{name}.weight_v"] = np.ascontiguousarray(
            tree.take(f"{scope}/kernel_v").T)
        sd[f"{name}.weight_g"] = tree.take(f"{scope}/kernel_g")
    _put_bias(sd, tree, scope, name)


def _put_conv(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    if isinstance(tree, _ToJax):
        tree.put(f"{scope}/kernel", tree.get(f"{name}.weight").transpose(2, 1, 0))
    else:
        sd[f"{name}.weight"] = np.ascontiguousarray(
            _kernel(tree, scope).transpose(2, 1, 0))
    _put_bias(sd, tree, scope, name)


def _put_conv_transpose(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    if tree.has(f"{scope}/kernel"):  # a generator without weight norm
        kernel = tree.take(f"{scope}/kernel")
    else:
        v = tree.take(f"{scope}/kernel_v")  # (k, in, out)
        g = tree.take(f"{scope}/kernel_g")  # (in,)
        kernel = _wn_fold(v, g, (0, 2), (1, -1, 1))
    sd[f"{name}.weight"] = np.ascontiguousarray(kernel.transpose(1, 2, 0))
    _put_bias(sd, tree, scope, name)


def _put_norm(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    if isinstance(tree, _ToJax):
        tree.put(f"{scope}/scale", tree.get(f"{name}.weight"))
        tree.put(f"{scope}/bias", tree.get(f"{name}.bias"))
    else:
        sd[f"{name}.weight"] = tree.take(f"{scope}/scale")
        sd[f"{name}.bias"] = tree.take(f"{scope}/bias")


def _put_embed(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    if isinstance(tree, _ToJax):
        tree.put(f"{scope}/embedding", tree.get(f"{name}.weight"))
    else:
        sd[f"{name}.weight"] = tree.take(f"{scope}/embedding")


# the ``buffers`` of a tree without them (an optimizer moment tree)
_NO_BUFFERS = object()


def _put_buffer(sd: dict, tree, buffers, path: str, key: str) -> None:
    if isinstance(tree, _ToJax):
        if tree.with_buffers:
            tree.put(path, tree.get(key), tree.buffers)
    elif buffers is not _NO_BUFFERS:
        sd[key] = buffers.take(path)


def _put_conformer(sd, tree, scope, name, use_norm: bool = False):
    if use_norm:
        _put_norm(sd, tree, f"{scope}/LayerNorm_0", f"{name}.norm")
    for i, part in enumerate(("conv1", "depthwise", "conv2")):
        _put_conv(sd, tree, f"{scope}/Conv1d_{i}", f"{name}.{part}")


def _put_pcmer(sd: dict, tree: _Leaves, buffers: _Leaves | None, scope: str,
               name: str, n_layers: int) -> None:
    """PCmer layers: norm, FAVOR+ attention (its projection matrix from the
    ``buffers`` tree at the same path), conformer with LayerNorm."""
    if buffers is None and not isinstance(tree, _ToJax):
        raise KeyError("JAX buffers missing: a PCmer decoder needs its FAVOR+ "
                       "projection matrices")
    for i in range(n_layers):
        s, n = f"{scope}/layer_{i}", f"{name}.layers.{i}"
        _put_norm(sd, tree, f"{s}/norm", f"{n}.norm")
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            _put_dense(sd, tree, f"{s}/attn/{proj}", f"{n}.attn.{proj}")
        _put_conformer(sd, tree, f"{s}/conformer", f"{n}.conformer", use_norm=True)
        _put_buffer(sd, tree, buffers, f"{s}/attn/projection_matrix",
                    f"{n}.attn.projection_matrix")


def _put_unit2control(sd: dict, tree: _Leaves, buffers: _Leaves | None,
                      u: str, un: str, pcmer: bool) -> None:
    """Unit2Control at JAX scope ``u`` -> port module ``un``: the conv
    stack (or its single conv), the embeddings, the decoder (PCmer layers
    with their FAVOR+ projection buffers, or the conv-only conformer), the
    norm and the weight-normed ``dense_out``."""
    _put_conv(sd, tree, f"{u}/stack_conv0", f"{un}.stack_conv0")
    if tree.present(sd, f"{u}/stack_norm/scale", f"{un}.stack_norm.weight"):
        _put_norm(sd, tree, f"{u}/stack_norm", f"{un}.stack_norm")
        _put_conv(sd, tree, f"{u}/stack_conv1", f"{un}.stack_conv1")
    for emb in ("f0_embed", "phase_embed", "volume_embed"):
        _put_dense(sd, tree, f"{u}/{emb}", f"{un}.{emb}")
    if tree.present(sd, f"{u}/spk_embed/embedding", f"{un}.spk_embed.weight"):
        _put_embed(sd, tree, f"{u}/spk_embed", f"{un}.spk_embed")
    if tree.present(sd, f"{u}/aug_shift_embed/kernel",
                    f"{un}.aug_shift_embed.weight"):
        _put_dense(sd, tree, f"{u}/aug_shift_embed", f"{un}.aug_shift_embed")
    if pcmer:
        _put_pcmer(sd, tree, buffers, f"{u}/decoder", f"{un}.decoder", 3)
    else:
        for i in range(3):
            _put_conformer(sd, tree,
                           f"{u}/decoder/CFNEncoderLayer_{i}/ConformerConvModule_0",
                           f"{un}.decoder.layers.{i}.conformer")
    _put_norm(sd, tree, f"{u}/norm", f"{un}.norm")
    _put_wn_dense(sd, tree, f"{u}/dense_out", f"{un}.dense_out")


def _put_naive_v2_diff(sd: dict, tree: _Leaves, d: str, dn: str,
                       n_layers: int) -> None:
    """NaiveV2Diff at JAX scope ``d`` -> port module ``dn``."""
    _put_conv(sd, tree, f"{d}/input_projection", f"{dn}.input_projection")
    _put_dense(sd, tree, f"{d}/diff_emb_0", f"{dn}.diff_emb_0")
    _put_dense(sd, tree, f"{d}/diff_emb_1", f"{dn}.diff_emb_1")
    for i in range(n_layers):
        s, n = f"{d}/layer_{i}", f"{dn}.layers.{i}"
        _put_conv(sd, tree, f"{s}/diffusion_step_projection",
                  f"{n}.diffusion_step_projection")
        _put_conv(sd, tree, f"{s}/condition_projection",
                  f"{n}.condition_projection")
        _put_conformer(sd, tree, f"{s}/conformer", f"{n}.conformer")
    _put_conv(sd, tree, f"{d}/output_projection", f"{dn}.output_projection")


def _put_wavenet(sd: dict, tree: _Leaves, d: str, dn: str, n_layers: int) -> None:
    """WaveNet at JAX scope ``d`` -> port module ``dn`` (its 1x1 convs' HIO
    kernels become (O, I, 1))."""
    _put_conv(sd, tree, f"{d}/input_projection", f"{dn}.input_projection")
    _put_dense(sd, tree, f"{d}/mlp_0", f"{dn}.mlp_0")
    _put_dense(sd, tree, f"{d}/mlp_1", f"{dn}.mlp_1")
    for i in range(n_layers):
        s, n = f"{d}/layer_{i}", f"{dn}.layers.{i}"
        _put_dense(sd, tree, f"{s}/diffusion_projection", f"{n}.diffusion_projection")
        for conv in ("dilated_conv", "conditioner_projection", "output_projection"):
            _put_conv(sd, tree, f"{s}/{conv}", f"{n}.{conv}")
    _put_conv(sd, tree, f"{d}/skip_projection", f"{dn}.skip_projection")
    _put_conv(sd, tree, f"{d}/output_projection", f"{dn}.output_projection")


def wavenet_state_dict(params: dict, n_layers: int) -> dict:
    """A WaveNet's own params -> the port's ``models/wavenet.WaveNet``
    state dict (numpy)."""
    tree = _Leaves({"wavenet": params})
    sd: dict = {}
    _put_wavenet(sd, tree, "wavenet", "wavenet", n_layers)
    tree.finish()
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _fill_family(sd: dict, tree, buf, mtype: str, n_layers: int | None) -> None:
    """The mapping of a model family, either way: ``tree`` is a ``_Leaves``
    of JAX params (``buf`` its buffers, ``sd`` filled) or a ``_ToJax`` of
    the state dict ``sd``. Scopes: a DDSP model at ``unit2ctrl/``; a
    cascade's synth at ``ddsp_model/unit2ctrl/`` beside its denoiser
    (``denoise_fn/``; the reflow velocity net at ``velocity_fn/``, beside
    ``ddsp_model`` rather than under ``reflow_model/``, since the cascade's
    own scope builds it); Unit2Mel's embeddings beside its WaveNet."""
    if mtype in ("Sins", "CombSub", "CombSubFast", "CombSubSuperFast"):
        _put_unit2control(sd, tree, buf, "unit2ctrl", "unit2ctrl",
                          pcmer=mtype != "CombSubSuperFast")
    elif mtype == "Diffusion":
        for emb in ("unit_embed", "f0_embed", "volume_embed"):
            _put_dense(sd, tree, emb, emb)
        if tree.present(sd, "spk_embed/embedding", "spk_embed.weight"):
            _put_embed(sd, tree, "spk_embed", "spk_embed")
        if tree.present(sd, "aug_shift_embed/kernel", "aug_shift_embed.weight"):
            _put_dense(sd, tree, "aug_shift_embed", "aug_shift_embed")
        _put_wavenet(sd, tree, "denoise_fn", "denoise_fn", n_layers)
    elif mtype == "DiffusionNew":
        _put_unit2control(sd, tree, buf, "ddsp_model/unit2ctrl",
                          "ddsp_model.unit2ctrl", pcmer=True)
        _put_wavenet(sd, tree, "denoise_fn", "denoise_fn", n_layers)
    elif mtype in ("DiffusionFast", "RectifiedFlow"):
        net = "denoise_fn" if mtype == "DiffusionFast" else "velocity_fn"
        _put_unit2control(sd, tree, None, "ddsp_model/unit2ctrl",
                          "ddsp_model.unit2ctrl", pcmer=False)
        _put_naive_v2_diff(sd, tree, net, net, n_layers)
    else:
        raise ValueError(f"unknown model type {mtype!r}")


def _state_dict(mtype: str, params: dict, buffers,
                n_layers: int | None = None) -> dict:
    tree = _Leaves(params)
    buf = _Leaves(buffers) if isinstance(buffers, dict) else buffers
    sd: dict = {}
    _fill_family(sd, tree, buf, mtype, n_layers)
    tree.finish()
    if isinstance(buf, _Leaves):
        buf.finish()
    return sd


def ddsp_state_dict(params: dict, buffers: dict | None = None,
                    pcmer: bool = True) -> dict:
    """A DDSP model's params (``unit2ctrl/...``) and buffers (the FAVOR+
    projections, ``unit2ctrl/decoder/layer_i/attn/projection_matrix``) ->
    the port's Sins / CombSub / CombSubFast (``pcmer``) or CombSubSuperFast
    state dict (numpy)."""
    return _state_dict("Sins" if pcmer else "CombSubSuperFast", params, buffers)


def unit2wav_fast_state_dict(params: dict, n_layers: int) -> dict:
    """Unit2WavFast params -> the port's ``models/cascade.Unit2WavFast``
    state dict (numpy)."""
    return _state_dict("DiffusionFast", params, None, n_layers)


def reflow_state_dict(params: dict, n_layers: int) -> dict:
    """ReflowUnit2Wav params -> the port's ``models/cascade.ReflowUnit2Wav``
    state dict (numpy)."""
    return _state_dict("RectifiedFlow", params, None, n_layers)


def unit2mel_state_dict(params: dict, n_layers: int) -> dict:
    """Unit2Mel params -> the port's ``models/cascade.Unit2Mel`` state
    dict."""
    return _state_dict("Diffusion", params, None, n_layers)


def unit2wav_state_dict(params: dict, buffers: dict | None,
                        n_layers: int) -> dict:
    """Unit2Wav params (a CombSubFast with its PCmer and FAVOR+
    ``buffers``) -> the port's ``models/cascade.Unit2Wav`` state dict."""
    return _state_dict("DiffusionNew", params, buffers, n_layers)


def model_state_dict(model_args, params: dict, buffers: dict | None = None) -> dict:
    """A checkpoint's params (and buffers) -> the state dict of the port's
    model for ``model_args`` (the config's ``model`` section)."""
    return _state_dict(model_args.type, params, buffers, model_args.n_layers)


def model_params(model_args, state: dict) -> tuple[dict, dict | None]:
    """The inverse of ``model_state_dict``: the port model's state dict
    (tensors or numpy) -> (JAX params tree, JAX buffers tree or None), with
    the JAX layout and names, v and g of the weight-normed Dense apart."""
    tree = _ToJax(state)
    _fill_family(state, tree, tree, model_args.type, model_args.n_layers)
    tree.finish()
    return tree.params, (tree.buffers or None)


def moments_state_dict(model_args, tree: dict) -> dict:
    """A tree shaped as the params (an optimizer's mu or nu) -> a dict by
    the port's parameter names (no buffers)."""
    return _state_dict(model_args.type, tree, _NO_BUFFERS, model_args.n_layers)


def moments_params(model_args, named: dict) -> dict:
    """The inverse: {port parameter name: tensor} -> the JAX params tree."""
    tree = _ToJax(named, with_buffers=False)
    _fill_family(named, tree, tree, model_args.type, model_args.n_layers)
    tree.finish()
    return tree.params


def generator_state_dict(params: dict, n_upsamples: int = 5,
                         n_kernels: int = 3, n_dilations: int = 3,
                         resblock: str = "1") -> dict:
    """NSF-HiFiGAN Generator params (the vocoder payload's ``params``) ->
    the port's ``models/nsf_hifigan.Generator`` state dict (numpy), with
    ResBlock1 (``convs1_n``, ``convs2_n``) or ResBlock2 (``convs_n``)."""
    tree = _Leaves(params)
    sd: dict = {}
    _put_dense(sd, tree, "m_source/l_linear", "m_source.l_linear")
    _put_conv(sd, tree, "conv_pre", "conv_pre")
    convs = ("convs1", "convs2") if str(resblock) == "1" else ("convs",)
    for i in range(n_upsamples):
        _put_conv_transpose(sd, tree, f"ups_{i}", f"ups.{i}")
        _put_conv(sd, tree, f"noise_convs_{i}", f"noise_convs.{i}")
        for j in range(n_kernels):
            r = i * n_kernels + j
            for n in range(n_dilations):
                for c in convs:
                    _put_conv(sd, tree, f"resblocks_{r}/{c}_{n}",
                              f"resblocks.{r}.{c}.{n}")
    _put_conv(sd, tree, "conv_post", "conv_post")
    tree.finish()
    return sd


# A conv of a training tree, either way: weight-normed (v, g), plain, or
# spectral-normed (its plain ``kernel``). ``perm`` takes the JAX kernel to
# the torch layout; ``inv`` back.
_CONV1D = ((2, 1, 0), (2, 1, 0))
_CONV_T = ((1, 2, 0), (2, 0, 1))
_CONV2D = ((3, 2, 0, 1), (2, 3, 1, 0))


def _put_train_conv(sd: dict, tree, scope: str, name: str, perms) -> None:
    perm, inv = perms
    if isinstance(tree, _ToJax):
        if f"{name}.weight_v" in sd:
            tree.put(f"{scope}/kernel_v", tree.get(f"{name}.weight_v").transpose(inv))
            tree.put(f"{scope}/kernel_g", tree.get(f"{name}.weight_g"))
        else:
            tree.put(f"{scope}/kernel", tree.get(f"{name}.weight").transpose(inv))
    elif tree.has(f"{scope}/kernel_v"):
        sd[f"{name}.weight_v"] = np.ascontiguousarray(
            tree.take(f"{scope}/kernel_v").transpose(perm))
        sd[f"{name}.weight_g"] = tree.take(f"{scope}/kernel_g")
    else:
        sd[f"{name}.weight"] = np.ascontiguousarray(
            tree.take(f"{scope}/kernel").transpose(perm))
    _put_bias(sd, tree, scope, name)


def _fill_generator(sd: dict, tree, cfg: dict) -> None:
    """The training generator (weight norm as (v, g)) <-> JAX ``Generator``
    params, in ``cfg``'s (the vocoder config's) shape."""
    _put_dense(sd, tree, "m_source/l_linear", "m_source.l_linear")
    _put_train_conv(sd, tree, "conv_pre", "conv_pre", _CONV1D)
    n_k = len(cfg["resblock_kernel_sizes"])
    n_d = len(cfg["resblock_dilation_sizes"][0])
    convs = ("convs1", "convs2") if str(cfg["resblock"]) == "1" else ("convs",)
    for i in range(len(cfg["upsample_rates"])):
        _put_train_conv(sd, tree, f"ups_{i}", f"ups.{i}", _CONV_T)
        _put_train_conv(sd, tree, f"noise_convs_{i}", f"noise_convs.{i}", _CONV1D)
        for j in range(n_k):
            r = i * n_k + j
            for n in range(n_d):
                for c in convs:
                    _put_train_conv(sd, tree, f"resblocks_{r}/{c}_{n}",
                                    f"resblocks.{r}.{c}.{n}", _CONV1D)
    _put_train_conv(sd, tree, "conv_post", "conv_post", _CONV1D)


def _fill_discriminators(sd: dict, tree, periods, msd_scales: int) -> None:
    """``train/vocoder_solver.Discriminators`` <-> JAX ``Discriminators``
    params (``mpd/disc_i``, ``msd/disc_i``)."""
    for i in range(len(periods)):
        for j in range(5):
            _put_train_conv(sd, tree, f"mpd/disc_{i}/convs_{j}",
                            f"mpd.discriminators.{i}.convs.{j}", _CONV2D)
        _put_train_conv(sd, tree, f"mpd/disc_{i}/conv_post",
                        f"mpd.discriminators.{i}.conv_post", _CONV2D)
    for i in range(msd_scales):
        for j in range(7):
            _put_train_conv(sd, tree, f"msd/disc_{i}/convs_{j}",
                            f"msd.discriminators.{i}.convs.{j}", _CONV1D)
        _put_train_conv(sd, tree, f"msd/disc_{i}/conv_post",
                        f"msd.discriminators.{i}.conv_post", _CONV1D)


def vocoder_train_state_dicts(params: dict, cfg: dict, periods,
                              msd_scales: int) -> tuple[dict, dict]:
    """A vocoder training tree (JAX ``train_vocoder``'s ``params`` or one of
    its optimizer moments: ``{"generator", "discriminator"}``) -> the state
    dicts of the port's training generator and ``Discriminators``."""
    gen, disc = {}, {}
    tree = _Leaves(params["generator"])
    _fill_generator(gen, tree, cfg)
    tree.finish()
    tree = _Leaves(params["discriminator"])
    _fill_discriminators(disc, tree, periods, msd_scales)
    tree.finish()
    return gen, disc


def vocoder_train_params(gen_sd: dict, disc_sd: dict, cfg: dict, periods,
                         msd_scales: int) -> dict:
    """The inverse: the two state dicts (tensors or numpy; parameters or a
    moment by parameter name) -> ``{"generator", "discriminator"}`` in the
    JAX layout and names."""
    out = {}
    for key, sd, fill in (
            ("generator", gen_sd, lambda sd, t: _fill_generator(sd, t, cfg)),
            ("discriminator", disc_sd,
             lambda sd, t: _fill_discriminators(sd, t, periods, msd_scales))):
        tree = _ToJax(sd, with_buffers=False)
        fill(sd, tree)
        tree.finish()
        out[key] = tree.params
    return out


def generator_params(gen_sd: dict, cfg: dict) -> dict:
    """A training generator's state dict (weight norm as (v, g); tensors or
    numpy) -> the JAX ``Generator`` params of ``cfg``'s shape, as the JAX
    package's NSF-HiFiGAN converter writes them (kernel_v and kernel_g
    apart)."""
    tree = _ToJax(gen_sd, with_buffers=False)
    _fill_generator(gen_sd, tree, cfg)
    tree.finish()
    return tree.params


def _put_attention(sd: dict, tree, scope: str, name: str, heads: int) -> None:
    """flax MultiHeadDotProductAttention: query/key/value kernels (dim,
    heads, head_dim) with (heads, head_dim) biases, the out kernel (heads,
    head_dim, dim) <-> four Linear layers."""
    if isinstance(tree, _ToJax):
        for proj in ("query", "key", "value"):
            w = tree.get(f"{name}.{proj}.weight")
            tree.put(f"{scope}/{proj}/kernel", w.T.reshape(w.shape[1], heads, -1))
            tree.put(f"{scope}/{proj}/bias",
                     tree.get(f"{name}.{proj}.bias").reshape(heads, -1))
        w = tree.get(f"{name}.out.weight")
        tree.put(f"{scope}/out/kernel", w.T.reshape(heads, -1, w.shape[0]))
        tree.put(f"{scope}/out/bias", tree.get(f"{name}.out.bias"))
        return
    for proj in ("query", "key", "value"):
        kernel = tree.take(f"{scope}/{proj}/kernel")
        sd[f"{name}.{proj}.weight"] = np.ascontiguousarray(
            kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{name}.{proj}.bias"] = tree.take(f"{scope}/{proj}/bias").reshape(-1)
    kernel = tree.take(f"{scope}/out/kernel")
    sd[f"{name}.out.weight"] = np.ascontiguousarray(
        kernel.reshape(-1, kernel.shape[-1]).T)
    sd[f"{name}.out.bias"] = tree.take(f"{scope}/out/bias")


def _fill_hubert(sd: dict, tree, config) -> None:
    """A ``HubertModel``'s JAX params <-> the port's state dict for
    ``config``. The JAX converter writes the encoder's final LayerNorm as
    ``norm`` even where the model has none (pre-LN with an early exit, whose
    flax module ignores it); reading, such a leaf is dropped."""
    for i in range(7):
        _put_conv(sd, tree, f"feature_extractor/conv{i}",
                  f"feature_extractor.convs.{i}")
        if config.extractor_layer_norm or i == 0:
            _put_norm(sd, tree, f"feature_extractor/norm{i}",
                      f"feature_extractor.norms.{i}")
    _put_norm(sd, tree, "fp_norm", "fp_norm")
    _put_dense(sd, tree, "fp_proj", "fp_proj")
    _put_conv(sd, tree, "pos_conv/conv", "pos_conv.conv")
    if config.final_norm:
        _put_norm(sd, tree, "norm", "norm")
    elif isinstance(tree, _Leaves) and tree.has("norm/scale"):
        tree.take("norm/scale")
        tree.take("norm/bias")
    for i in range(config.layers_run):
        s, n = f"layer{i}", f"layers.{i}"
        _put_attention(sd, tree, f"{s}/attn", f"{n}.attn", config.heads)
        for part in ("norm1", "norm2"):
            _put_norm(sd, tree, f"{s}/{part}", f"{n}.{part}")
        for part in ("fc1", "fc2"):
            _put_dense(sd, tree, f"{s}/{part}", f"{n}.{part}")
    if config.proj_dim and tree.present(sd, "proj/kernel", "proj.weight"):
        _put_dense(sd, tree, "proj", "proj")


def hubert_state_dict(params: dict, config) -> dict:
    """A ``HubertModel``'s JAX params (the tree under ``params`` of its
    variables) -> the port's ``features/hubert.HubertModel`` state dict
    (numpy) for ``config`` (a ``HubertConfig``)."""
    tree = _Leaves(params)
    sd: dict = {}
    _fill_hubert(sd, tree, config)
    tree.finish()
    return sd


def hubert_variables(state: dict, config) -> dict:
    """The inverse: the port model's state dict (tensors or numpy) -> the
    JAX variables ``{"params": ...}`` for ``config``."""
    tree = _ToJax(state)
    _fill_hubert(state, tree, config)
    tree.finish()
    return {"params": tree.params}


def unflatten(flat: dict, sep: str = ".") -> dict:
    """A flat {"a.b.c": array} dict (an .npz param file) -> nested tree
    (the port's copy of ddsp_svc_tpu/convert/flatdict.py ``unflatten``)."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def load_params(path: str | None):
    """Converted flax params (.msgpack or .npz) -> tree, or None when there
    is no such file (the port's copy of ddsp_svc_tpu/utils/params.py
    ``load_params``)."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".msgpack"):
        return read_msgpack(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return unflatten(dict(data))
    return None


def load_state(module: nn.Module, state: dict) -> nn.Module:
    """Load a numpy state dict strictly: a port parameter left unset or a
    key the module lacks raises. An optional ``aug_shift_embed`` that the
    checkpoint does not carry is dropped from the module."""
    for name, sub in list(module.named_modules()):
        if name.endswith("aug_shift_embed") and f"{name}.weight" not in state:
            parent = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            setattr(parent, name.rsplit(".", 1)[-1], None)
    device = next(module.parameters()).device
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
               for k, v in state.items()}
    missing, unexpected = module.load_state_dict(tensors, strict=False)
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    return module


# The f0 nets (features/rmvpe.py, crepe.py, fcpe.py). Their trees are the
# flax variables, ``params`` beside ``batch_stats`` (none for FCPE), so the
# paths below start with the collection. A 2-D conv kernel (kh, kw, in, out)
# maps to (out, in, kh, kw) (``_CONV2D``), a transposed one to (in, out,
# kh, kw), unflipped (ROADMAP C(e)).
_CONV_T2D = ((2, 3, 0, 1), (2, 3, 0, 1))


def _put_batch_norm(sd: dict, tree, scope: str, name: str) -> None:
    """flax BatchNorm (``params`` scale and bias, ``batch_stats`` mean and
    var) <-> ``models/nn.BatchNorm``."""
    _put_norm(sd, tree, f"params/{scope}", name)
    for stat in ("mean", "var"):
        if isinstance(tree, _ToJax):
            tree.put(f"batch_stats/{scope}/{stat}", tree.get(f"{name}.{stat}"))
        else:
            sd[f"{name}.{stat}"] = tree.take(f"batch_stats/{scope}/{stat}")


# flax GRUCell's gates in torch's [r; z; n] order: (input part, hidden part)
_GRU_GATES = (("ir", "hr"), ("iz", "hz"), ("in", "hn"))


def _put_gru_direction(sd: dict, tree, scope: str, suffix: str) -> None:
    """A flax ``GRUCell`` (``ir``/``iz``/``in`` kernel and bias,
    ``hr``/``hz`` kernel only, ``hn`` kernel and bias) <-> one direction of
    ``torch.nn.GRU``: the kernels transposed and stacked [r; z; n], the
    input biases stacked, the hidden bias [0; 0; b_hn]."""
    keys = [f"gru.{w}_l0{suffix}" for w in
            ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    if isinstance(tree, _ToJax):
        w_ih, w_hh, b_ih, b_hh = (tree.get(k) for k in keys)
        h = w_hh.shape[1]
        if np.any(b_hh[:2 * h]):
            raise ValueError("a flax GRUCell has no r and z hidden biases: "
                             f"{keys[3]}[:{2 * h}] must be 0")
        for g, (gi, gh) in enumerate(_GRU_GATES):
            rows = slice(g * h, (g + 1) * h)
            tree.put(f"{scope}/{gi}/kernel", w_ih[rows].T)
            tree.put(f"{scope}/{gi}/bias", b_ih[rows])
            tree.put(f"{scope}/{gh}/kernel", w_hh[rows].T)
        tree.put(f"{scope}/hn/bias", b_hh[2 * h:])
        return
    w_ih, w_hh, b_ih = [], [], []
    for gi, gh in _GRU_GATES:
        w_ih.append(tree.take(f"{scope}/{gi}/kernel").T)
        b_ih.append(tree.take(f"{scope}/{gi}/bias"))
        w_hh.append(tree.take(f"{scope}/{gh}/kernel").T)
    b_hn = tree.take(f"{scope}/hn/bias")
    b_hh = np.concatenate([np.zeros(2 * len(b_hn), np.float32), b_hn])
    for key, value in zip(keys, (np.concatenate(w_ih), np.concatenate(w_hh),
                                 np.concatenate(b_ih), b_hh)):
        sd[key] = np.ascontiguousarray(value)


def _put_conv_block_res(sd, tree, scope: str, name: str) -> None:
    for i in (1, 2):
        _put_train_conv(sd, tree, f"params/{scope}/conv{i}", f"{name}.conv{i}",
                        _CONV2D)
        _put_batch_norm(sd, tree, f"{scope}/bn{i}", f"{name}.bn{i}")
    if tree.present(sd, f"params/{scope}/shortcut/kernel",
                    f"{name}.shortcut.weight"):
        _put_train_conv(sd, tree, f"params/{scope}/shortcut",
                        f"{name}.shortcut", _CONV2D)


def _fill_rmvpe(sd: dict, tree, n_blocks: int, n_gru: int) -> None:
    """E2E0(n_blocks, n_gru) <-> ``features/rmvpe.E2E0``."""
    _put_batch_norm(sd, tree, "unet/in_bn", "unet.in_bn")
    for part, n_parts in (("enc", 5), ("inter", 4), ("dec", 5)):
        for i in range(n_parts):
            s, n = f"unet/{part}{i}", f"unet.{part}.{i}"
            if part == "dec":
                _put_train_conv(sd, tree, f"params/{s}/deconv", f"{n}.deconv",
                                _CONV_T2D)
                _put_batch_norm(sd, tree, f"{s}/bn1", f"{n}.bn1")
            for j in range(n_blocks):
                _put_conv_block_res(sd, tree, f"{s}/block{j}", f"{n}.blocks.{j}")
    _put_train_conv(sd, tree, "params/cnn", "cnn", _CONV2D)
    if n_gru:
        _put_gru_direction(sd, tree, "params/gru/fw", "")
        _put_gru_direction(sd, tree, "params/gru/bw", "_reverse")
    _put_dense(sd, tree, "params/fc", "fc")


def _fill_crepe(sd: dict, tree) -> None:
    """CREPE full <-> ``features/crepe.Crepe``: the (k, 1, in, out) kernels
    as (out, in, k, 1)."""
    for i in range(6):
        _put_train_conv(sd, tree, f"params/conv{i + 1}", f"convs.{i}", _CONV2D)
        _put_batch_norm(sd, tree, f"bn{i + 1}", f"bns.{i}")
    _put_dense(sd, tree, "params/classifier", "classifier")


def _fill_fcpe(sd: dict, tree, n_layers: int) -> None:
    """CFNaiveMelPE <-> ``features/fcpe.CFNaiveMelPE``."""
    _put_conv(sd, tree, "params/input_conv0", "input_conv0")
    _put_norm(sd, tree, "params/input_norm", "input_norm")
    _put_conv(sd, tree, "params/input_conv1", "input_conv1")
    for i in range(n_layers):
        _put_conformer(sd, tree,
                       f"params/net/CFNEncoderLayer_{i}/ConformerConvModule_0",
                       f"net.layers.{i}.conformer")
    _put_norm(sd, tree, "params/norm", "norm")
    _put_wn_dense(sd, tree, "params/output_proj", "output_proj")


def _f0_fill(kind: str, **cfg):
    if kind == "rmvpe":
        return lambda sd, tree: _fill_rmvpe(sd, tree, cfg.get("n_blocks", 4),
                                            cfg.get("n_gru", 1))
    if kind == "crepe":
        return _fill_crepe
    if kind == "fcpe":
        return lambda sd, tree: _fill_fcpe(sd, tree, cfg.get("n_layers", 6))
    raise ValueError(f"unknown f0 net {kind!r}")


def f0_net_state_dict(kind: str, variables: dict, **cfg) -> dict:
    """A converted f0 net's flax variables (``{"params": ..., "batch_stats":
    ...}``; FCPE's bare params too, as the JAX ``FCPEInfer`` takes them) ->
    the port's state dict (numpy). ``cfg``: RMVPE's ``n_blocks`` (4) and
    ``n_gru`` (1), FCPE's ``n_layers`` (6)."""
    if kind == "fcpe" and "params" not in variables:
        variables = {"params": variables}
    tree = _Leaves(variables)
    sd: dict = {}
    _f0_fill(kind, **cfg)(sd, tree)
    tree.finish()
    return sd


def f0_net_variables(kind: str, state: dict, **cfg) -> dict:
    """The inverse: the port net's state dict (tensors or numpy) -> the
    flax variables in the JAX layout and names, as the JAX package's
    ``F0Extractor`` reads them from ``pretrain/<kind>/...msgpack``."""
    tree = _ToJax(state)
    _f0_fill(kind, **cfg)(state, tree)
    tree.finish()
    return tree.params


def rmvpe_state_dict(variables: dict, n_blocks: int = 4, n_gru: int = 1) -> dict:
    return f0_net_state_dict("rmvpe", variables, n_blocks=n_blocks, n_gru=n_gru)


def crepe_state_dict(variables: dict) -> dict:
    return f0_net_state_dict("crepe", variables)


def fcpe_state_dict(variables: dict, n_layers: int = 6) -> dict:
    return f0_net_state_dict("fcpe", variables, n_layers=n_layers)


def rmvpe_variables(state: dict, n_blocks: int = 4, n_gru: int = 1) -> dict:
    return f0_net_variables("rmvpe", state, n_blocks=n_blocks, n_gru=n_gru)


def crepe_variables(state: dict) -> dict:
    return f0_net_variables("crepe", state)


def fcpe_variables(state: dict, n_layers: int = 6) -> dict:
    return f0_net_variables("fcpe", state, n_layers=n_layers)


def write_msgpack(path: str, tree: dict) -> None:
    """A tree -> a flax msgpack file (the inverse of ``read_msgpack``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_codec.packb(tree))
