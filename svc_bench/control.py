"""The readings that a cell's correctness limit is set from, in one
process: for each seed, the program's (the cell's pipeline with that seed's
weights, driven for a short window at the cell's own load, its sampled
outputs against the reference) and, for the first ``--control`` seeds, the
control's (the reference in TF32, the nearest precision below the
configuration's float32, in the program's place, on the same requests).

    python3 svc_bench/control.py --workload dfast.serve.r60 --seeds 11 12 13 \\
        --control 4 --seconds 6

It prints one JSON line a seed and never runs in the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svc_bench import check, generator, harness, registry  # noqa: E402


def readings(cell: dict, seeds: list[int], n_control: int, seconds: float,
             device) -> list[dict]:
    mix = cell["mix"]
    check.precision(False)
    system = cell["system"].build(cell["config"], mix, seeds[0], device)
    system.warm()
    block = cell["config"]["data"]["block_size"]
    out = []
    for i, seed in enumerate(seeds):
        system.reseed(seed)
        requests = cell["source"](mix, seed, system.sample_rate)
        watch = system.watch(requests, int(mix["check"]["requests"]), seed)
        system.open_window({requests[j].seed for j in watch}, False)
        _, _, done = harness.drive(system, requests, mix, seconds,
                                   generator.gaps(mix, seed))
        system.close_window()
        picked = harness.first_admissions(done, watch)
        prog = system.readings(picked)
        row = {"seed": seed, "requests": len(done),
               "failed": sum(d.output is None for d in done),
               "frames": [len(d.request.audio) // block + 1 for d in picked],
               "rows": [len(system.tap.row(d.seed)[0]["seeds"]) if system.tap.row(d.seed)
                        else 0 for d in picked],
               "program": prog,
               "program_max": {k: max(e[k] for e in prog) for k in prog[0]}}
        if i < n_control:
            ctrl = system.control(picked)
            row.update(control=ctrl,
                       control_max={k: max(e[k] for e in ctrl) for k in ctrl[0]},
                       control_min={k: min(e[k] for e in ctrl) for k in ctrl[0]})
        out.append(row)
        print(json.dumps(row), flush=True)
    system.release()
    return out


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=6.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    cell = registry.cell(registry.benchmark(), a.workload)
    rows = readings(cell, a.seeds, a.control, a.seconds, torch.device("cuda", 0))
    keys = rows[0]["program_max"]
    summary = {"workload": a.workload, "seconds": time.perf_counter() - t0,
               "lower": {k: max(r["program_max"][k] for r in rows) for k in keys},
               "upper": {k: min(r["control_max"][k] for r in rows if "control_max" in r)
                         for k in keys if any("control_max" in r for r in rows)}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
