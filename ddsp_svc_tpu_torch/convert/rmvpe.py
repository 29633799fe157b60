"""RMVPE torch checkpoint -> the port's ``features/rmvpe.E2E0`` (mirrors
ddsp_svc_tpu/convert/rmvpe.py).

Upstream (encoder/rmvpe, E2E0(4, 1, (2, 2))): DeepUnet0's ConvBlockRes
sequences with BatchNorms, the transposed-conv decoders, the 3-channel
head conv, a one-layer BiGRU and the 360-class linear. The TimbreFilter
weights are unused by the DeepUnet0 forward (deepunet.py:196-208) and
dropped. A flax GRUCell has no r and z hidden biases, so the converter
adds torch's into the input biases (as the JAX converter does) and the
port's GRU takes them there with those hidden biases zero.
"""
from __future__ import annotations

import numpy as np

from ..io.jax_params import f0_net_variables
from .common import load_state_dict, rename, write_tree


def _block_rules(up: str, port: str) -> list:
    """ConvBlockRes sequences ``<up>.{j}`` -> ``<port>.blocks.{j}``; ``up``
    holds one group (the part's index, ``\\1`` in ``port``), so the block's
    index is ``\\2`` and a name's last part ``\\3``."""
    block = port + r".blocks.\2"
    return [
        (up + r"\.(\d+)\.conv\.0\.weight", block + ".conv1.weight"),
        (up + r"\.(\d+)\.conv\.3\.weight", block + ".conv2.weight"),
        (up + r"\.(\d+)\.conv\.1\.(?:running_)?(weight|bias|mean|var)", block + r".bn1.\3"),
        (up + r"\.(\d+)\.conv\.4\.(?:running_)?(weight|bias|mean|var)", block + r".bn2.\3"),
        (up + r"\.(\d+)\.shortcut\.(weight|bias)", block + r".shortcut.\3"),
    ]


RULES = (
    [(r"unet\.encoder\.bn\.(?:running_)?(weight|bias|mean|var)", r"unet.in_bn.\1"),
     (r"unet\.decoder\.layers\.(\d+)\.conv1\.0\.weight", r"unet.dec.\1.deconv.weight"),
     (r"unet\.decoder\.layers\.(\d+)\.conv1\.1\.(?:running_)?(weight|bias|mean|var)",
      r"unet.dec.\1.bn1.\2"),
     (r"cnn\.(weight|bias)", r"cnn.\1"),
     (r"fc\.0\.gru\.((weight|bias)_(ih|hh)_l0(_reverse)?)", r"gru.\1"),
     (r"fc\.1\.(weight|bias)", r"fc.\1")]
    + _block_rules(r"unet\.encoder\.layers\.(\d+)\.conv", r"unet.enc.\1")
    + _block_rules(r"unet\.intermediate\.layers\.(\d+)\.conv", r"unet.inter.\1")
    + _block_rules(r"unet\.decoder\.layers\.(\d+)\.conv2", r"unet.dec.\1")
)


def convert_state_dict(sd: dict) -> dict:
    """{upstream name: array} -> the port's E2E0 state dict (numpy)."""
    out = rename(sd, RULES)
    for suffix in ("", "_reverse"):
        b_ih, b_hh = out[f"gru.bias_ih_l0{suffix}"], out[f"gru.bias_hh_l0{suffix}"]
        h2 = 2 * (len(b_hh) // 3)
        out[f"gru.bias_ih_l0{suffix}"] = np.concatenate([b_ih[:h2] + b_hh[:h2], b_ih[h2:]])
        out[f"gru.bias_hh_l0{suffix}"] = np.concatenate(
            [np.zeros(h2, b_hh.dtype), b_hh[h2:]])
    return out


def convert_rmvpe(ckpt_path: str, out_path: str | None = None) -> dict:
    """Convert; write the flax variables to ``out_path`` (default the
    checkpoint's name with ``.msgpack``) and return the port's state dict."""
    state = convert_state_dict(load_state_dict(ckpt_path))
    out_path = out_path or ckpt_path.rsplit(".", 1)[0] + ".msgpack"
    write_tree(out_path, f0_net_variables("rmvpe", state))
    print(f" [*] rmvpe: {ckpt_path} -> {out_path}")
    return state
