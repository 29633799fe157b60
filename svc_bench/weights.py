"""The served models' weights, made from the seed on the device in one
draw: every uniform parameter is a slice of one ``torch.rand`` of all of
them, from a ``torch.Generator`` on the device seeded with the run's seed,
scaled to its bound; norms are ones and zeros; a weight-normed layer's gain
is the norm of its drawn direction. The same seed gives the same weights,
which the benchmark hands to the port and, after the window, to the plain
reference."""
from __future__ import annotations

import torch

from .reference.params import spec


def make(cfg: dict, seed: int, device) -> dict:
    """-> {"encoder" | "model" | "vocoder": {state-dict name: tensor}}."""
    groups = spec(cfg)
    sizes = [(g, name, shape, init) for g, params in groups.items()
             for name, (shape, init) in params.items()]
    total = sum(torch.Size(shape).numel() for _, _, shape, init in sizes
                if init[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: dict = {g: {} for g in groups}
    at = 0
    for g, name, shape, init in sizes:
        n = torch.Size(shape).numel()
        if init[0] == "uniform":
            out[g][name] = (draw[at:at + n] * init[1]).reshape(shape)
            at += n
        elif init[0] == "ones":
            out[g][name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[g][name] = torch.zeros(shape, device=device)
    for g, name, shape, init in sizes:
        if init[0] == "norm_of":
            v = out[g][init[1]]
            out[g][name] = torch.sqrt(torch.sum(v * v, dim=1))
    return out
