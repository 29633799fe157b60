"""torchcrepe 'full' .pth -> the port's ``features/crepe.Crepe`` (mirrors
ddsp_svc_tpu/convert/crepe.py): ``conv{1..6}``, ``conv{1..6}_BN`` and the
classifier."""
from __future__ import annotations

from ..io.jax_params import f0_net_variables
from .common import load_state_dict, rename, write_tree

RULES = [
    (r"conv([1-6])\.(weight|bias)", r"convs.\1.\2"),
    (r"conv([1-6])_BN\.(?:running_)?(weight|bias|mean|var)", r"bns.\1.\2"),
    (r"classifier\.(weight|bias)", r"classifier.\1"),
]


def convert_state_dict(sd: dict) -> dict:
    """{upstream name: array} -> the port's Crepe state dict (numpy): the
    upstream's 1-based layers are the port's 0-based ``convs`` and
    ``bns``."""
    out = {}
    for name, value in rename(sd, RULES).items():
        parts = name.split(".")
        if parts[0] in ("convs", "bns"):
            parts[1] = str(int(parts[1]) - 1)
        out[".".join(parts)] = value
    return out


def convert_crepe(ckpt_path: str, out_path: str | None = None) -> dict:
    """Convert; write the flax variables to ``out_path`` (default the
    checkpoint's name with ``.msgpack``) and return the port's state dict."""
    state = convert_state_dict(load_state_dict(ckpt_path))
    out_path = out_path or ckpt_path.rsplit(".", 1)[0] + ".msgpack"
    write_tree(out_path, f0_net_variables("crepe", state))
    print(f" [*] crepe: {ckpt_path} -> {out_path}")
    return state
