"""Shared helpers of the converters (mirrors ddsp_svc_tpu/convert/common.py
``load_state_dict``, ``fold_weight_norm`` and ``check_tree_shapes``), and
the renaming that takes an upstream state dict to the port's names.

``check_tree_shapes`` is kept for parity with the JAX package's public
helpers, for a user who holds a converted tree against a model's template;
the converters do not call it (their strictness is the renaming's and the
loaders'), and the tests hold the written trees with it."""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..io.jax_params import write_msgpack


def load_state_dict(path: str) -> dict:
    """``torch.load`` a checkpoint on the CPU -> {key: numpy array}. Takes a
    raw state dict or one wrapped under ``model``, ``generator`` or
    ``state_dict``, and strips ``module.`` (a DataParallel save)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("model", "generator", "state_dict"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(wrapper), dict):
            ckpt = ckpt[wrapper]
            break
    return {k.replace("module.", ""): v.detach().cpu().numpy()
            for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def fold_weight_norm(g: np.ndarray, v: np.ndarray, dim: int = 0) -> np.ndarray:
    """torch ``weight_norm(weight_g, weight_v)`` folded into one weight:
    g * v / ||v||, the norm over every axis but ``dim`` (floored at 1e-12),
    in numpy as the JAX converter folds it."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def rename(sd: dict, rules) -> dict:
    """{upstream name: array} -> {port name: array} by ``rules``, a sequence
    of (regex over the whole upstream name, port name template). The first
    rule that matches renames a key; a key no rule matches is dropped, as
    the JAX converter ignores what it does not read (a diffusion's noise
    schedule, a batch norm's step count). A weight-norm gain ``weight_g``
    is flattened to the port's (n,)."""
    compiled = [(re.compile(pattern + r"\Z"), template) for pattern, template in rules]
    out = {}
    for key, value in sd.items():
        for pattern, template in compiled:
            m = pattern.match(key)
            if m:
                name = m.expand(template)
                if name.endswith("weight_g"):
                    value = value.reshape(-1)
                out[name] = value
                break
    return out


def check_tree_shapes(converted: dict, template: dict, path: str = "") -> list[str]:
    """Compare a converted tree against a template; returns the mismatches
    (empty for an exact structural match)."""
    problems = []
    t_keys, c_keys = set(template), set(converted)
    problems += [f"missing {path}/{k}" for k in sorted(t_keys - c_keys)]
    problems += [f"unexpected {path}/{k}" for k in sorted(c_keys - t_keys)]
    for k in sorted(t_keys & c_keys):
        tv, cv = template[k], converted[k]
        if isinstance(tv, dict):
            if not isinstance(cv, dict):
                problems.append(f"type mismatch at {path}/{k}")
            else:
                problems += check_tree_shapes(cv, tv, f"{path}/{k}")
        elif np.shape(cv) != np.shape(tv):
            problems.append(f"shape {path}/{k}: {np.shape(cv)} vs {np.shape(tv)}")
    return problems


def write_tree(path: str, tree: dict) -> None:
    """A tree -> a flax msgpack file, atomically (a crash never leaves a
    truncated file that a loader would then read)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    write_msgpack(tmp, tree)
    os.replace(tmp, path)
