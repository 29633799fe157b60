"""The one traffic generator: a mix file (``traffic/<mix>.json``) of
parameters -> the requests of a run and their arrival gaps, made from
``--seed``.

The mix's ``"source"`` names the kind of its requests
(``sources/<source>.py``); every source gives every seed the same multiset
of request sizes (the quantiles of the mix's distributions), in an order the
seed shuffles, so seeds differ in what they say and in their order, not in
how much work they ask for. Arrivals are Poisson at the mix's
``"rate_rps"``, through a door of ``"door"`` requests in flight (the
harness's ``drive``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    index: int
    audio: np.ndarray  # float32 samples at the configuration's rate
    seed: int
    pitch_hz: float


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n evenly spaced quantiles (at (i + 0.5) / n) of a distribution
    spec: {"log_uniform": [lo, hi]}."""
    if "log_uniform" not in spec:
        raise ValueError(f"unknown distribution {spec}")
    lo, hi = spec["log_uniform"]
    return lo * (hi / lo) ** ((np.arange(n) + 0.5) / n)


def gaps(mix: dict, seed: int, n: int = 1024) -> np.ndarray:
    """The gaps between arrivals (s): n quantiles of the exponential
    distribution at the mix's rate (Poisson arrivals), in an order the seed
    shuffles, cycled through by the driver."""
    u = (np.arange(n) + 0.5) / n
    rng = np.random.default_rng(int(seed) ^ 0xA77)
    return rng.permutation(-np.log1p(-u) / float(mix["rate_rps"]))
