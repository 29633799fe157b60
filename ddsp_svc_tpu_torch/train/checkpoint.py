"""Checkpoints in the JAX package's format (mirrors
ddsp_svc_tpu/train/checkpoint.py), so either package resumes the other's:

  - ``<expdir>/model_<step>.ckpt`` is one flax msgpack payload
    ``{"global_step", "params", "opt_state"?, "buffers"?}`` with the params
    in the JAX layout and names (``io/jax_params.model_params``), the
    optimizer state as optax's chain state dict, and a PCmer model's FAVOR+
    projections under ``buffers`` (which the JAX ``load_model`` reads);
    written atomically;
  - resume takes the highest numeric suffix; a ``model_0`` dropped into a
    fresh expdir warm-starts shape-tolerantly (params absent or of another
    shape are skipped, as torch's ``strict=False``);
  - retention: the previous save is deleted unless its step is a multiple
    of ``interval_force_save``.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..io import msgpack_codec
from ..io.jax_params import load_state, model_params, model_state_dict

CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(expdir: str, step: int, model: torch.nn.Module, model_args,
                    opt_state: dict | None = None) -> str:
    """Write ``model`` (and the optax-form ``opt_state``) at ``step``."""
    os.makedirs(expdir, exist_ok=True)
    params, buffers = model_params(model_args, model.state_dict())
    payload = {"global_step": int(step), "params": params}
    if opt_state is not None:
        payload["opt_state"] = _host(opt_state)
    if buffers:
        payload["buffers"] = buffers
    path = os.path.join(expdir, f"model_{step}.ckpt")
    # atomic: a crash mid-write must never leave a truncated model_<step>
    # that latest_checkpoint() would then pick up
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(msgpack_codec.packb(payload))
    os.replace(tmp, path)
    return path


def latest_checkpoint(expdir: str) -> str | None:
    """The highest-step model_<step>.ckpt in ``expdir``, or None."""
    if not os.path.isdir(expdir):
        return None
    best, best_step = None, -1
    for name in os.listdir(expdir):
        m = CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(expdir, name)
    return best


def load_checkpoint(path: str) -> tuple[dict, int]:
    """-> (payload dict with numpy leaves, its global step)."""
    with open(path, "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    return payload, int(payload.get("global_step", 0))


def merge_tree(template, loaded, strict: bool = False, path: str = ""):
    """``loaded`` merged into ``template`` (both JAX trees): a leaf missing
    from ``loaded`` or of another shape keeps the template's value unless
    ``strict`` (the JAX ``restore_into``)."""
    if isinstance(template, dict):
        out = {}
        for k, tv in template.items():
            if isinstance(loaded, dict) and k in loaded:
                out[k] = merge_tree(tv, loaded[k], strict, f"{path}/{k}")
            elif strict:
                raise KeyError(f"missing checkpoint key {path}/{k}")
            else:
                out[k] = tv
        return out
    arr, t = np.asarray(loaded), np.asarray(template)
    if arr.shape != t.shape:
        if strict:
            raise ValueError(f"shape mismatch at {path}: {arr.shape} vs {t.shape}")
        return template
    return arr.astype(t.dtype)


def restore_into(model: torch.nn.Module, model_args, payload: dict,
                 strict: bool = False) -> torch.nn.Module:
    """Load a payload's params (and buffers, where the model has them) into
    ``model``, shape-tolerantly unless ``strict``."""
    params, buffers = model_params(model_args, model.state_dict())
    params = merge_tree(params, payload["params"], strict)
    if buffers:
        buffers = merge_tree(buffers, payload.get("buffers") or {}, strict)
    return load_state(model, model_state_dict(model_args, params, buffers))


def delete_checkpoint(expdir: str, step: int) -> None:
    path = os.path.join(expdir, f"model_{step}.ckpt")
    if os.path.exists(path):
        os.remove(path)


def apply_retention(expdir: str, prev_step: int, interval_force_save: int) -> None:
    """Delete the checkpoint of ``prev_step`` unless it is a multiple of
    ``interval_force_save`` (an unset interval keeps only the latest)."""
    if prev_step >= 0 and (interval_force_save <= 0
                           or prev_step % interval_force_save != 0):
        delete_checkpoint(expdir, prev_step)
