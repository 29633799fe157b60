"""Flat <-> nested param dicts for .npz param files (mirrors
ddsp_svc_tpu/convert/flatdict.py; ``unflatten`` is the port's
``io/jax_params.unflatten``).

``flatten`` is kept for parity with the JAX package's public helpers, for
a user who writes a converted tree as flat ``.npz`` arrays; nothing in the
package calls it, and the tests use it to compare trees leaf by leaf."""
from __future__ import annotations

import numpy as np

from ..io.jax_params import unflatten

__all__ = ["flatten", "unflatten"]


def flatten(tree: dict, prefix: str = "", sep: str = ".") -> dict:
    """A nested tree -> {"a.b.c": array} (the inverse of ``unflatten``)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key, sep))
        else:
            out[key] = np.asarray(v)
    return out
