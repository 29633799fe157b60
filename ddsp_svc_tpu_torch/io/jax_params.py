"""JAX param trees -> the port's state dicts.

Reads the JAX package's params (a nested dict of numpy arrays, as
``flax`` keeps them) or its checkpoint file (``train/checkpoint.py``: one
msgpack payload whose arrays are flax's ndarray ext type, decoded here by
the port's own hook; ``msgpack`` is imported only when a file is read).

A model's ``buffers`` tree (the FAVOR+ projections of a PCmer decoder)
maps to the port's buffers the same way, leaf by leaf.

Layout rules (the inverse of the torch->flax converters): Dense kernel
(in, out) -> Linear weight (out, in); Conv1d kernel (k, in, out) -> (out,
in, k); ConvTranspose1d kernel (k, in, out) -> (in, out, k), no flip. Weight
norm is folded as the JAX modules fold it, with the +1e-12: Conv1d / Dense
normalise over every axis but the output one; ConvTranspose1d normalises
per *input* channel. Every leaf must map, and every port parameter must be
set, or a ``KeyError`` names the leftovers.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

# flax.serialization's msgpack ext codes for arrays and numpy scalars
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 leaves are not supported by the port")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a flax array")


def read_msgpack(path: str) -> dict:
    """A flax msgpack file (a JAX checkpoint or vocoder payload) -> tree.
    (flax splits leaves above 1 GiB into chunks; no leaf of these models
    comes near that, and such a tree fails the leaf mapping by name.)"""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


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

    def finish(self):
        if self.leaves:
            raise KeyError("JAX params left unmapped: " + ", ".join(sorted(self.leaves)))


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
    if tree.has(f"{scope}/bias"):
        sd[f"{name}.bias"] = tree.take(f"{scope}/bias")


def _put_dense(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_kernel(tree, scope).T)
    _put_bias(sd, tree, scope, name)


def _put_conv(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
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
    sd[f"{name}.weight"] = tree.take(f"{scope}/scale")
    sd[f"{name}.bias"] = tree.take(f"{scope}/bias")


def _put_conformer(sd, tree, scope, name, use_norm: bool = False):
    if use_norm:
        _put_norm(sd, tree, f"{scope}/LayerNorm_0", f"{name}.norm")
    for i, part in enumerate(("conv1", "depthwise", "conv2")):
        _put_conv(sd, tree, f"{scope}/Conv1d_{i}", f"{name}.{part}")


def _put_pcmer(sd: dict, tree: _Leaves, buffers: _Leaves | None, scope: str,
               name: str, n_layers: int) -> None:
    """PCmer layers: norm, FAVOR+ attention (its projection matrix from the
    ``buffers`` tree at the same path), conformer with LayerNorm."""
    if buffers is None:
        raise KeyError("JAX buffers missing: a PCmer decoder needs its FAVOR+ "
                       "projection matrices")
    for i in range(n_layers):
        s, n = f"{scope}/layer_{i}", f"{name}.layers.{i}"
        _put_norm(sd, tree, f"{s}/norm", f"{n}.norm")
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            _put_dense(sd, tree, f"{s}/attn/{proj}", f"{n}.attn.{proj}")
        _put_conformer(sd, tree, f"{s}/conformer", f"{n}.conformer", use_norm=True)
        sd[f"{n}.attn.projection_matrix"] = buffers.take(
            f"{s}/attn/projection_matrix")


def _put_unit2control(sd: dict, tree: _Leaves, buffers: _Leaves | None,
                      u: str, un: str, pcmer: bool) -> None:
    """Unit2Control at JAX scope ``u`` -> port module ``un``: the conv
    stack (or its single conv), the embeddings, the decoder (PCmer layers
    with their FAVOR+ projection buffers, or the conv-only conformer), the
    norm and the weight-normed ``dense_out``."""
    _put_conv(sd, tree, f"{u}/stack_conv0", f"{un}.stack_conv0")
    if tree.has(f"{u}/stack_norm/scale"):
        _put_norm(sd, tree, f"{u}/stack_norm", f"{un}.stack_norm")
        _put_conv(sd, tree, f"{u}/stack_conv1", f"{un}.stack_conv1")
    for emb in ("f0_embed", "phase_embed", "volume_embed"):
        _put_dense(sd, tree, f"{u}/{emb}", f"{un}.{emb}")
    if tree.has(f"{u}/spk_embed/embedding"):
        sd[f"{un}.spk_embed.weight"] = tree.take(f"{u}/spk_embed/embedding")
    if tree.has(f"{u}/aug_shift_embed/kernel"):
        _put_dense(sd, tree, f"{u}/aug_shift_embed", f"{un}.aug_shift_embed")
    if pcmer:
        _put_pcmer(sd, tree, buffers, f"{u}/decoder", f"{un}.decoder", 3)
    else:
        for i in range(3):
            _put_conformer(sd, tree,
                           f"{u}/decoder/CFNEncoderLayer_{i}/ConformerConvModule_0",
                           f"{un}.decoder.layers.{i}.conformer")
    _put_norm(sd, tree, f"{u}/norm", f"{un}.norm")
    _put_dense(sd, tree, f"{u}/dense_out", f"{un}.dense_out")


def ddsp_state_dict(params: dict, buffers: dict | None = None,
                    pcmer: bool = True) -> dict:
    """A DDSP model's params (``unit2ctrl/...``) and buffers (the FAVOR+
    projections, ``unit2ctrl/decoder/layer_i/attn/projection_matrix``) ->
    the port's Sins / CombSub / CombSubFast (``pcmer``) or CombSubSuperFast
    state dict (numpy)."""
    tree = _Leaves(params)
    buf = _Leaves(buffers) if buffers is not None else None
    sd: dict = {}
    _put_unit2control(sd, tree, buf, "unit2ctrl", "unit2ctrl", pcmer)
    tree.finish()
    if buf is not None:
        buf.finish()
    return sd


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


def unit2wav_fast_state_dict(params: dict, n_layers: int) -> dict:
    """Unit2WavFast params (``ddsp_model/...``, ``denoise_fn/...``) -> the
    port's ``models/cascade.Unit2WavFast`` state dict (numpy)."""
    tree = _Leaves(params)
    sd: dict = {}
    _put_unit2control(sd, tree, None, "ddsp_model/unit2ctrl",
                      "ddsp_model.unit2ctrl", pcmer=False)
    _put_naive_v2_diff(sd, tree, "denoise_fn", "denoise_fn", n_layers)
    tree.finish()
    return sd


def reflow_state_dict(params: dict, n_layers: int) -> dict:
    """ReflowUnit2Wav params (``ddsp_model/...``; the velocity net at
    ``velocity_fn/``, beside ``ddsp_model`` rather than under
    ``reflow_model/``, since the cascade's own scope builds it) -> the
    port's ``models/cascade.ReflowUnit2Wav`` state dict (numpy)."""
    tree = _Leaves(params)
    sd: dict = {}
    _put_unit2control(sd, tree, None, "ddsp_model/unit2ctrl",
                      "ddsp_model.unit2ctrl", pcmer=False)
    _put_naive_v2_diff(sd, tree, "velocity_fn", "velocity_fn", n_layers)
    tree.finish()
    return sd


def unit2mel_state_dict(params: dict, n_layers: int) -> dict:
    """Unit2Mel params (the embeddings; the WaveNet at ``denoise_fn/``,
    beside them) -> the port's ``models/cascade.Unit2Mel`` state dict."""
    tree = _Leaves(params)
    sd: dict = {}
    for emb in ("unit_embed", "f0_embed", "volume_embed"):
        _put_dense(sd, tree, emb, emb)
    if tree.has("spk_embed/embedding"):
        sd["spk_embed.weight"] = tree.take("spk_embed/embedding")
    if tree.has("aug_shift_embed/kernel"):
        _put_dense(sd, tree, "aug_shift_embed", "aug_shift_embed")
    _put_wavenet(sd, tree, "denoise_fn", "denoise_fn", n_layers)
    tree.finish()
    return sd


def unit2wav_state_dict(params: dict, buffers: dict | None,
                        n_layers: int) -> dict:
    """Unit2Wav params (``ddsp_model/...`` a CombSubFast with its PCmer and
    FAVOR+ ``buffers``; the WaveNet at ``denoise_fn/``) -> the port's
    ``models/cascade.Unit2Wav`` state dict (numpy)."""
    tree = _Leaves(params)
    buf = _Leaves(buffers) if buffers is not None else None
    sd: dict = {}
    _put_unit2control(sd, tree, buf, "ddsp_model/unit2ctrl",
                      "ddsp_model.unit2ctrl", pcmer=True)
    _put_wavenet(sd, tree, "denoise_fn", "denoise_fn", n_layers)
    tree.finish()
    if buf is not None:
        buf.finish()
    return sd


def model_state_dict(model_args, params: dict, buffers: dict | None = None) -> dict:
    """A checkpoint's params (and buffers) -> the state dict of the port's
    model for ``model_args`` (the config's ``model`` section)."""
    mtype, n_layers = model_args.type, model_args.n_layers
    if mtype in ("Sins", "CombSub", "CombSubFast", "CombSubSuperFast"):
        return ddsp_state_dict(params, buffers, pcmer=mtype != "CombSubSuperFast")
    if mtype == "Diffusion":
        return unit2mel_state_dict(params, n_layers)
    if mtype == "DiffusionNew":
        return unit2wav_state_dict(params, buffers, n_layers)
    if mtype == "RectifiedFlow":
        return reflow_state_dict(params, n_layers)
    return unit2wav_fast_state_dict(params, n_layers)


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


def _put_attention(sd: dict, tree: _Leaves, scope: str, name: str) -> None:
    """flax MultiHeadDotProductAttention: query/key/value kernels (dim,
    heads, head_dim) with (heads, head_dim) biases, the out kernel (heads,
    head_dim, dim) -> four Linear layers."""
    for proj in ("query", "key", "value"):
        kernel = tree.take(f"{scope}/{proj}/kernel")
        sd[f"{name}.{proj}.weight"] = np.ascontiguousarray(
            kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{name}.{proj}.bias"] = tree.take(f"{scope}/{proj}/bias").reshape(-1)
    kernel = tree.take(f"{scope}/out/kernel")
    sd[f"{name}.out.weight"] = np.ascontiguousarray(
        kernel.reshape(-1, kernel.shape[-1]).T)
    sd[f"{name}.out.bias"] = tree.take(f"{scope}/out/bias")


def hubert_state_dict(params: dict, config) -> dict:
    """A ``HubertModel``'s JAX params (the tree under ``params`` of its
    variables) -> the port's ``features/hubert.HubertModel`` state dict
    (numpy) for ``config`` (a ``HubertConfig``)."""
    tree = _Leaves(params)
    sd: dict = {}
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
    for i in range(config.layers_run):
        s, n = f"layer{i}", f"layers.{i}"
        _put_attention(sd, tree, f"{s}/attn", f"{n}.attn")
        for part in ("norm1", "norm2"):
            _put_norm(sd, tree, f"{s}/{part}", f"{n}.{part}")
        for part in ("fc1", "fc2"):
            _put_dense(sd, tree, f"{s}/{part}", f"{n}.{part}")
    if config.proj_dim:
        _put_dense(sd, tree, "proj", "proj")
    tree.finish()
    return sd


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
