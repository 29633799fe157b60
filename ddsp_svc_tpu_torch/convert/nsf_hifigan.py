"""NSF-HiFiGAN torch checkpoint (+ ``config.json``) -> the port (mirrors
ddsp_svc_tpu/convert/nsf_hifigan.py).

Upstream (nsf_hifigan/models.py:207-274 and env.py): the generator's state
dict with weight-normed ``conv_pre``, ``ups``, ``resblocks`` and
``conv_post`` (``weight_g`` / ``weight_v`` kept) and plain ``noise_convs``;
its names are the port's training generator's (``models/nsf_hifigan.py``
with ``weight_norm=True``). The file is the JAX converter's payload,
``{"params", "config"}``, the params with kernel_v and kernel_g apart; the
returned state dict is the serving generator's, folded as
``models/registry.load_vocoder`` folds the file.
"""
from __future__ import annotations

import json
import os

from ..io.jax_params import generator_params, generator_state_dict
from .common import load_state_dict, rename, write_tree

# the config.json keys the payload keeps (JAX nsf_hifigan.py:72-78)
KEEP = ("sampling_rate", "num_mels", "n_fft", "win_size", "hop_size", "fmin",
        "fmax", "upsample_rates", "upsample_kernel_sizes",
        "upsample_initial_channel", "resblock", "resblock_kernel_sizes",
        "resblock_dilation_sizes")

RULES = [
    (r"(conv_pre|conv_post|ups\.\d+|resblocks\.\d+\.convs[12]?\.\d+)"
     r"\.(weight_v|weight_g|bias)", r"\1.\2"),
    (r"(noise_convs\.\d+|m_source\.l_linear)\.(weight|bias)", r"\1.\2"),
]


def convert_state_dict(sd: dict) -> dict:
    """{upstream name: array} -> the port's training generator state dict
    (weight norm as (v, g), each gain flattened to (n,))."""
    return rename(sd, RULES)


def convert_nsf_hifigan(ckpt_path: str, out_path: str | None = None) -> dict:
    """``ckpt_path``: the 'model' file, with ``config.json`` beside it
    (nsf_hifigan/models.py:27-34). Writes ``out_path`` (default
    ``ckpt_path + ".msgpack"``, where the loaders look) and returns the
    serving generator's state dict."""
    with open(os.path.join(os.path.dirname(ckpt_path), "config.json")) as f:
        config = json.load(f)
    params = generator_params(convert_state_dict(load_state_dict(ckpt_path)),
                              config)
    out_path = out_path or ckpt_path + ".msgpack"
    write_tree(out_path, {"params": params,
                          "config": {k: config[k] for k in KEEP if k in config}})
    print(f" [*] nsf-hifigan: {ckpt_path} -> {out_path}")
    return generator_state_dict(
        params, len(config["upsample_rates"]),
        len(config["resblock_kernel_sizes"]),
        len(config["resblock_dilation_sizes"][0]), str(config.get("resblock", "1")))
