"""How ``correct`` is decided, the part every cell shares: a cell's system
(``systems/<name>.py``) gives, for each request on its watch list, readings
against the plain reference under ``reference/``; each number of the cell's
limits file (``limits/<cell>.json``: ``{name: {"reading", "limit"}}``) is
the worst reading of its kind over the watch list, and a request that never
came counts as failed. ``correct`` holds when every number is within its
limit and at least one request was read."""
from __future__ import annotations

import numpy as np
import torch

MISSING = 1e30  # the reading of something that never came (finite in JSON)


def rel_err(got, want) -> float:
    """||got - want|| / ||want||; a missing, misshapen or non-finite ``got``
    reads MISSING."""
    if got is None:
        return MISSING
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return MISSING
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def precision(tf32: bool) -> None:
    """float32 products as stated (TF32 off), or the control's TF32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def judge(readings: list[dict], limits: dict, failed: int) -> tuple[bool, dict]:
    """-> (correct, {number: {"value", "limit"}})."""
    numbers = {name: {"value": max((e[n["reading"]] for e in readings), default=MISSING),
                      "limit": n["limit"]}
               for name, n in limits.items()}
    numbers["failed_requests"] = {"value": failed, "limit": 0}
    ok = bool(readings) and all(n["value"] <= n["limit"] for n in numbers.values())
    return ok, numbers
