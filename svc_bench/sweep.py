"""The sweep that finds a cell's knee, the highest rate the system
sustains, once, on the card: the cell's system driven at each of the given
rates in turn, through a door too wide to fill, in one process.

    python3 svc_bench/sweep.py --workload dfast.serve.r60 --rates 12 16 20 \\
        --seconds 15 --seed 7

It prints one JSON line a rate: the rate offered (requests/s and seconds
of audio a second), the audio completed a second, the latency quantiles
and how many requests were still unanswered when the last one was sent.
It never runs in the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svc_bench import check, generator, harness, registry  # noqa: E402


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = registry.cell(registry.benchmark(), a.workload)
    check.precision(False)
    system = cell["system"].build(cell["config"], cell["mix"], a.seed,
                                  torch.device("cuda", 0))
    system.warm()
    requests = cell["source"](cell["mix"], a.seed, system.sample_rate)
    sr = system.sample_rate
    mean_s = float(np.mean([len(r.audio) / sr for r in requests]))
    for rate in a.rates:
        # a door wide enough never to fill below the knee
        mix = dict(cell["mix"], rate_rps=rate, door=1024)
        t_open, t_close, done = harness.drive(system, requests, mix, a.seconds,
                                              generator.gaps(mix, a.seed))
        last = max(d.t0 for d in done)
        lat = sorted((d.t1 - d.t0) * 1e3 for d in done)
        print(json.dumps({
            "rate_rps": rate, "offered_audio_s_per_s": rate * mean_s,
            "audio_s_per_s": sum(len(d.output) for d in done if d.output is not None)
            / system.out_rate / (t_close - t_open),
            "requests": len(done), "p50_ms": lat[len(lat) // 2],
            "p95_ms": harness.percentile(lat, 95.0), "max_ms": lat[-1],
            "open_at_last_send": int(sum(d.t1 > last for d in done)),
            "drain_s": t_close - last}), flush=True)
        time.sleep(1.0)
    system.release()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
