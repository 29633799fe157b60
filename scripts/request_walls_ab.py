#!/usr/bin/env python3
"""Request walls of two copies of the port on one CUDA card, in turns
(``a b b a``), to compare a host-side change (for example routing the
kernels through registered operators) end to end.

python3 scripts/request_walls_ab.py ab/parent .   # from the repository root

Each run is a fresh process that imports the port from its root (building
that copy's kernels into its own ``build/``), draws the DiffusionFast model
of configs/diffusion-fast.yaml (6 x 512 trunk) and the default
NSF-HiFiGAN with random weights from one seed, and times
``SvcPipeline.infer_features``: the 2, 5 and 10 s requests of chip_smoke's
phase 4 (k_step 100, DPM-Solver++ at speedup 10; one cold and WARM warm
runs each) and the 2 s request of each of phase 11's samplers (DDIM, PNDM,
UniPC at speedup 10, the DDPM chain at speedup 1; one cold and WARM warm).
Host clock around calls that end in ``torch.cuda.synchronize()``; TF32
off. Prints one JSON line per run and a table of warm medians.

python3 scripts/request_walls_ab.py --dispatch [PAIRS]

compares, in one process of this copy, the wrappers of K1, K3 and K4 as
they run eagerly (each calling its kernel's ``_launch`` directly) against
the same wrappers routed through their registered operators
``torch.ops.ddsp_svc.*`` (``kernels.traced`` forced true, as under
``torch.export``), in PAIRS alternated pairs (default 20; the order flips
every pair): first K3's and K1's host time a
call (2000 back-to-back calls at the 10 s request's shapes and at 8
frames, then one synchronize), then the requests above (WARM_AB warm runs
each a side, medians); last, FINE pairs of single runs of the 10 s
request, the sides alternated run by run (``a b b a``), so that a drift
of the card or the host falls on both sides alike. One process takes the
two sides on the same allocator, cuDNN algorithms and clocks, so the
difference is the dispatcher's. Prints one JSON line.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

SEED, SR, BLOCK, N_UNIT, WARM, WARM_AB, FINE = 1234, 44100, 512, 768, 15, 5, 200
REQUESTS = ((2, "dpm-solver", 10), (5, "dpm-solver", 10), (10, "dpm-solver", 10),
            (2, "ddim", 10), (2, "pndm", 10), (2, "unipc", 10),
            (2, "dpm-solver", 1))  # speedup 1: the full DDPM chain


def _setup(root: str):
    """The port imported from ``root``, its kernels built; the pipeline of
    the docstring's model and the requests' inputs."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.models.vocoder import Vocoder
    from ddsp_svc_tpu_torch.ops import kernels
    from ddsp_svc_tpu_torch.utils.config import DotDict

    if not torch.cuda.is_available():
        raise SystemExit("request_walls_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    args = DotDict({"data": {"sampling_rate": SR, "block_size": BLOCK,
                             "encoder_out_channels": N_UNIT},
                    "model": {"type": "DiffusionFast", "win_length": 2048,
                              "n_layers": 6, "n_chans": 512, "k_step_max": 100,
                              "use_pitch_aug": True, "n_spk": 1}})
    gen = torch.Generator().manual_seed(SEED)
    model = random_init_(build_model(args), gen)
    vocoder = random_init_(Vocoder("nsf-hifigan"), gen)
    pipe = SvcPipeline.from_parts(model, None, args, vocoder, seed=SEED)
    rng = np.random.default_rng(SEED)
    requests = []
    for seconds, method, speedup in REQUESTS:
        t = int(seconds * SR) // BLOCK + 1
        f0 = np.full((1, t, 1), 220.0, np.float32)
        inputs = dict(units=rng.standard_normal((1, t, N_UNIT)).astype(np.float32),
                      f0=f0, volume=np.full((1, t, 1), 0.3, np.float32),
                      frame_mask=np.ones(t, np.float32))
        name = "ddpm chain" if speedup == 1 else method
        requests.append((f"{name} {seconds} s", functools.partial(
            pipe.infer_features, **inputs, k_step=100, speedup=speedup,
            method=method)))
    return torch, model, requests


def _walls(torch, call, n: int) -> list[float]:
    """``n`` walls of ``call()`` in ms, each ended by a synchronize."""
    runs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def run(root: str) -> dict:
    """One copy's walls (in this process, the port imported from ``root``)."""
    torch, _, requests = _setup(root)
    out = {"root": root, "card": torch.cuda.get_device_name(0), "walls_ms": {}}
    for name, call in requests:
        runs = _walls(torch, call, 1 + WARM)
        warm = sorted(runs[1:])
        out["walls_ms"][name] = {
            "median": warm[len(warm) // 2], "min": warm[0], "max": warm[-1],
            "cold": runs[0]}
    return out


def _median(xs: list[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (xs[len(xs) // 2 - 1]
                                                       + xs[len(xs) // 2])


def dispatch(pairs: int) -> dict:
    """The operators against direct launches, in one process (docstring)."""
    torch, model, requests = _setup(".")
    from ddsp_svc_tpu_torch.ops import cuda_conformer, cuda_source, kernels

    sides = {"operator": lambda: True, "direct": kernels.traced}

    def use(side: str) -> None:
        kernels.traced = sides[side]

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    layer = model.denoise_fn.layers[0]
    weights = [p.detach().to(dev) for p in layer.kernel_weights()]
    calls = {}
    for frames in (862, 8):
        x = torch.randn(1, frames, 512, generator=gen).to(dev)
        cond = torch.randn(1, frames, weights[0].shape[1], generator=gen).to(dev)
        step = torch.randn(1, 512, generator=gen).to(dev)
        f0 = torch.full((1, frames, 1), 220.0, device=dev)
        calls[f"K3 {frames} frames"] = functools.partial(
            cuda_conformer.conformer_layer, x, cond, step, weights)
        calls[f"K1 {frames} frames"] = functools.partial(
            cuda_source.combtooth, f0, SR, BLOCK)
    per_call = {name: {side: [] for side in sides} for name in calls}
    walls = {name: {side: [] for side in sides} for name, _ in requests}
    with torch.no_grad():
        for pair in range(pairs):
            order = list(sides) if pair % 2 == 0 else list(sides)[::-1]
            for side in order:
                use(side)
                for name, call in calls.items():
                    call()  # warm
                    per_call[name][side].append(
                        _walls(torch, lambda: [call() for _ in range(2000)], 1)[0]
                        / 2000 * 1e3)
                for name, call in requests:
                    runs = _walls(torch, call, 1 + WARM_AB)
                    walls[name][side].append(_median(runs[1:]))
        ten_s = dict(requests)["dpm-solver 10 s"]
        fine = {side: [] for side in sides}
        for pair in range(FINE):
            for side in (list(sides) if pair % 2 == 0 else list(sides)[::-1]):
                use(side)
                fine[side].append(_walls(torch, ten_s, 1)[0])
    use("direct")

    def summary(table: dict) -> dict:
        out = {}
        for name, by_side in table.items():
            op, direct = by_side["operator"], by_side["direct"]
            ratios = [a / b - 1.0 for a, b in zip(op, direct)]
            out[name] = {"operator": _median(op), "direct": _median(direct),
                         "operator_over_direct_median": _median(ratios),
                         "pairs_operator_slower": sum(r > 0 for r in ratios),
                         "pairs": len(ratios)}
        return out

    def quartiles(xs: list[float]) -> list[float]:
        xs = sorted(xs)
        return [xs[len(xs) // 4], _median(xs), xs[3 * len(xs) // 4]]

    diffs = [a - b for a, b in zip(fine["operator"], fine["direct"])]
    return {"card": torch.cuda.get_device_name(0), "pairs": pairs,
            "per_call_us": summary(per_call), "request_ms": summary(walls),
            "fine_10s_ms": {"pairs": FINE,
                            "operator_quartiles": quartiles(fine["operator"]),
                            "direct_quartiles": quartiles(fine["direct"]),
                            "difference_quartiles": quartiles(diffs),
                            "pairs_operator_slower": sum(d > 0 for d in diffs)}}


def main(roots: list[str]) -> None:
    order = [roots[0], roots[1], roots[1], roots[0]]
    results = []
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--run", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"request_walls_ab: the run of {root} failed")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    names = list(results[0]["walls_ms"])
    print(f"warm medians (ms) on {results[0]['card']}, runs in the order "
          + " ".join(r["root"] for r in results))
    for name in names:
        print(f"  {name:18s} " + "  ".join(
            f"{r['walls_ms'][name]['median']:9.2f}" for r in results))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        print(json.dumps(run(sys.argv[2])), flush=True)
    elif sys.argv[1:2] == ["--dispatch"]:
        print(json.dumps(dispatch(int(sys.argv[2]) if sys.argv[2:] else 20)),
              flush=True)
    else:
        if len(sys.argv) != 3:
            raise SystemExit(__doc__)
        main(sys.argv[1:])
