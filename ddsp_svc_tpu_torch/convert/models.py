"""Upstream DDSP-SVC model checkpoints (``model_<step>.pt``) -> the port
(mirrors ddsp_svc_tpu/convert/models.py ``convert_reference_model``).

Every type the JAX converter takes: CombSubSuperFast; Sins, CombSub and
CombSubFast (the PCmer decoder, with its FAVOR+ ``projection_matrix``
buffers); Diffusion (Unit2Mel); DiffusionNew; DiffusionFast; RectifiedFlow.
Upstream and the port are both in torch layout with the output projection's
weight norm kept as (v, g), so each upstream name maps straight to the
port's module name; the JAX tree of the written checkpoint is the port's
state dict through ``io/jax_params.model_params``.

Upstream module paths: ddsp/unit2control.py:26-109 (the conv stack
``stack.{0,1,3}`` or one conv ``stack``), ddsp/pcmer.py:114-148,
diffusion/model_conformer_naive.py:117-150 (``net.{2,4,6}``),
diffusion/naive_v2_diff.py:103-170, diffusion/wavenet.py,
diffusion/vocoder.py:269-314, reflow/vocoder.py:149-198.
"""
from __future__ import annotations

import os
import re

from ..io.jax_params import model_params
from .common import load_state_dict, rename, write_tree


def _unit2control_rules(up: str, port: str) -> list:
    """Unit2Control at upstream prefix ``up`` -> the port's ``port``: the
    conv stack, the embeddings, the naive conformer or PCmer decoder, the
    norm and the weight-normed ``dense_out``."""
    e = re.escape(up)
    naive = e + r"decoder\.encoder_layers\.(\d+)\.conformer\.net\."
    pcmer = e + r"decoder\._layers\.(\d+)\."
    return [
        (e + r"stack\.0\.(weight|bias)", port + r"stack_conv0.\1"),
        (e + r"stack\.1\.(weight|bias)", port + r"stack_norm.\1"),
        (e + r"stack\.3\.(weight|bias)", port + r"stack_conv1.\1"),
        (e + r"stack\.(weight|bias)", port + r"stack_conv0.\1"),
        (e + r"(f0_embed|phase_embed|volume_embed|aug_shift_embed|spk_embed|norm)"
         r"\.(weight|bias)", port + r"\1.\2"),
        (e + r"dense_out\.(weight_v|weight_g|bias)", port + r"dense_out.\1"),
        (naive + r"2\.(weight|bias)", port + r"decoder.layers.\1.conformer.conv1.\2"),
        (naive + r"4\.(weight|bias)", port + r"decoder.layers.\1.conformer.depthwise.\2"),
        (naive + r"6\.(weight|bias)", port + r"decoder.layers.\1.conformer.conv2.\2"),
        (pcmer + r"attn\.(to_q|to_k|to_v|to_out)\.(weight|bias)",
         port + r"decoder.layers.\1.attn.\2.\3"),
        (pcmer + r"attn\.fast_attention\.projection_matrix",
         port + r"decoder.layers.\1.attn.projection_matrix"),
        (pcmer + r"norm\.(weight|bias)", port + r"decoder.layers.\1.norm.\2"),
        (pcmer + r"conformer\.net\.0\.(weight|bias)",
         port + r"decoder.layers.\1.conformer.norm.\2"),
        (pcmer + r"conformer\.net\.2\.(weight|bias)",
         port + r"decoder.layers.\1.conformer.conv1.\2"),
        (pcmer + r"conformer\.net\.4\.conv\.(weight|bias)",
         port + r"decoder.layers.\1.conformer.depthwise.\2"),
        (pcmer + r"conformer\.net\.6\.(weight|bias)",
         port + r"decoder.layers.\1.conformer.conv2.\2"),
    ]


def _naive_v2_diff_rules(up: str, port: str) -> list:
    """NaiveV2Diff (use_mlp=False) at ``up`` -> the port's ``port``."""
    e = re.escape(up)
    layer = e + r"residual_layers\.(\d+)\."
    return [
        (e + r"(input_projection|output_projection)\.(weight|bias)", port + r"\1.\2"),
        (e + r"diffusion_embedding\.1\.(weight|bias)", port + r"diff_emb_0.\1"),
        (e + r"diffusion_embedding\.3\.(weight|bias)", port + r"diff_emb_1.\1"),
        (layer + r"(diffusion_step_projection|condition_projection)\.(weight|bias)",
         port + r"layers.\1.\2.\3"),
        (layer + r"conformer\.net\.2\.(weight|bias)", port + r"layers.\1.conformer.conv1.\2"),
        (layer + r"conformer\.net\.4\.(weight|bias)",
         port + r"layers.\1.conformer.depthwise.\2"),
        (layer + r"conformer\.net\.6\.(weight|bias)", port + r"layers.\1.conformer.conv2.\2"),
    ]


def _wavenet_rules(up: str, port: str) -> list:
    """The diffusion WaveNet at ``up`` -> the port's ``port``."""
    e = re.escape(up)
    return [
        (e + r"(input_projection|skip_projection|output_projection)\.(weight|bias)",
         port + r"\1.\2"),
        (e + r"mlp\.0\.(weight|bias)", port + r"mlp_0.\1"),
        (e + r"mlp\.2\.(weight|bias)", port + r"mlp_1.\1"),
        (e + r"residual_layers\.(\d+)\.(dilated_conv|diffusion_projection|"
         r"conditioner_projection|output_projection)\.(weight|bias)",
         port + r"layers.\1.\2.\3"),
    ]


def model_rules(mtype: str) -> list:
    """The renaming of an upstream model of ``mtype`` to the port's
    module names; ``NotImplementedError`` for a type the JAX converter
    does not take either."""
    if mtype in ("Sins", "CombSub", "CombSubFast", "CombSubSuperFast"):
        return _unit2control_rules("unit2ctrl.", "unit2ctrl.")
    if mtype == "Diffusion":
        return ([(r"(unit_embed|f0_embed|volume_embed|aug_shift_embed|spk_embed)"
                  r"\.(weight|bias)", r"\1.\2")]
                + _wavenet_rules("decoder.denoise_fn.", "denoise_fn."))
    if mtype == "DiffusionNew":
        return (_unit2control_rules("ddsp_model.unit2ctrl.", "ddsp_model.unit2ctrl.")
                + _wavenet_rules("diff_model.denoise_fn.", "denoise_fn."))
    if mtype == "DiffusionFast":
        return (_unit2control_rules("ddsp_model.unit2ctrl.", "ddsp_model.unit2ctrl.")
                + _naive_v2_diff_rules("diff_model.denoise_fn.", "denoise_fn."))
    if mtype == "RectifiedFlow":
        return (_unit2control_rules("ddsp_model.unit2ctrl.", "ddsp_model.unit2ctrl.")
                + _naive_v2_diff_rules("reflow_model.velocity_fn.", "velocity_fn."))
    raise NotImplementedError(f"no converter for model type {mtype!r}")


def convert_state_dict(sd: dict, model_args) -> dict:
    """An upstream model's {name: array} -> the port's state dict (numpy)
    of the model for ``model_args`` (the config's ``model`` section)."""
    return rename(sd, model_rules(model_args.type))


def convert_reference_model(ckpt_path: str, args, out_path: str | None = None
                            ) -> dict:
    """Convert an upstream ``model_<step>.pt`` for a config (DotDict) ->
    the port's state dict. With ``out_path`` also write the checkpoint the
    JAX converter writes: ``model_<step>.ckpt`` (the step from the file
    name, 0 without one) in ``out_path``'s directory, ``{"global_step",
    "params", "buffers"?}``, a PCmer model's FAVOR+ projections under
    ``buffers``. Each port parameter must be filled, and each renamed
    tensor must map to the JAX tree, or a ``KeyError`` names them."""
    state = convert_state_dict(load_state_dict(ckpt_path), args.model)
    params, buffers = model_params(args.model, state)
    if out_path:
        m = re.search(r"model_(\d+)", os.path.basename(ckpt_path))
        step = int(m.group(1)) if m else 0
        payload = {"global_step": step, "params": params}
        if buffers:
            payload["buffers"] = buffers
        out_dir = os.path.dirname(out_path) or "."
        os.makedirs(out_dir, exist_ok=True)
        write_tree(os.path.join(out_dir, f"model_{step}.ckpt"), payload)
    return state
