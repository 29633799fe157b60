"""torchfcpe checkpoint -> the port's ``features/fcpe.CFNaiveMelPE``
(mirrors ddsp_svc_tpu/convert/fcpe.py).

Upstream (torchfcpe CFNaiveMelPE, the wheel the reference imports at
ddsp/vocoder.py:121-133):

  input_stack.0            Conv1d(128, 512, 3)
  input_stack.1            GroupNorm(4, 512)
  input_stack.3            Conv1d(512, 512, 3)
  net.encoder_layers.{i}.conformer.net.{2,4,6}   conv-only conformer module
  norm                     LayerNorm(512)
  output_proj              weight_norm(Linear(512, 360))

Bundled checkpoints wrap the state dict under ``model`` (``common.
load_state_dict``); its buffers (the cent table, the blur mask) are not
parameters and are dropped.
"""
from __future__ import annotations

from ..io.jax_params import f0_net_variables
from .common import load_state_dict, rename, write_tree

RULES = [
    (r"input_stack\.0\.(weight|bias)", r"input_conv0.\1"),
    (r"input_stack\.1\.(weight|bias)", r"input_norm.\1"),
    (r"input_stack\.3\.(weight|bias)", r"input_conv1.\1"),
    (r"net\.encoder_layers\.(\d+)\.conformer\.net\.2\.(weight|bias)",
     r"net.layers.\1.conformer.conv1.\2"),
    (r"net\.encoder_layers\.(\d+)\.conformer\.net\.4\.(weight|bias)",
     r"net.layers.\1.conformer.depthwise.\2"),
    (r"net\.encoder_layers\.(\d+)\.conformer\.net\.6\.(weight|bias)",
     r"net.layers.\1.conformer.conv2.\2"),
    (r"norm\.(weight|bias)", r"norm.\1"),
    (r"output_proj\.(weight_v|weight_g|bias)", r"output_proj.\1"),
]


def n_layers(sd: dict) -> int:
    """The conformer layers of an upstream state dict (at least one)."""
    n = 0
    while f"net.encoder_layers.{n}.conformer.net.2.weight" in sd:
        n += 1
    if n == 0:
        raise ValueError("no CFNaiveMelPE conformer layers found in state dict")
    return n


def convert_state_dict(sd: dict) -> dict:
    """{upstream name: array} -> the port's CFNaiveMelPE state dict."""
    n_layers(sd)
    return rename(sd, RULES)


def convert_fcpe(ckpt_path: str, out_path: str | None = None) -> dict:
    """Convert; write the flax variables to ``out_path`` (default the
    checkpoint's name with ``.msgpack``) and return the port's state dict."""
    sd = load_state_dict(ckpt_path)
    state = convert_state_dict(sd)
    out_path = out_path or ckpt_path.rsplit(".", 1)[0] + ".msgpack"
    write_tree(out_path, f0_net_variables("fcpe", state, n_layers=n_layers(sd)))
    print(f" [*] fcpe: {ckpt_path} -> {out_path}")
    return state
