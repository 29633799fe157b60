"""One run of one cell: set-up (the cell's system and its requests from the
seed, the system's warm-up and a warm pass of the cell's traffic), the
measured window, the metrics, and the correctness check once the window has
closed and the system's state is freed.

The harness only resolves a cell's parts by name (``registry.cell``) and
calls them. A cell's system (``systems/<name>.py``) has ``build(cfg, mix,
seed, device)``, whose object gives:

- ``sample_rate``, ``out_rate``: of the requests' audio and of the answers;
- ``warm()``: the shapes the cell's traffic uses;
- ``serve(request, seed) -> np.ndarray``: one request, blocking, safe to
  call from many threads;
- ``watch(requests, n, seed) -> set``: the pool indices the check reads;
- ``open_window(watch_seeds, traced)``, ``close_window()``: counters reset,
  the watched requests' inputs kept, the traced run's spans installed and
  removed; ``counters``: the program's counters over the window;
- ``release()``: the program's state freed;
- ``readings(picked) -> list[dict]``: each watched request against the
  plain reference.

The window drives one loop: requests arrive on the mix's Poisson schedule
(``"rate_rps"``) through a door of ``"door"`` requests in flight, which
bounds the serving threads; an arrival that finds the door full waits
there, and each request is timed from its admission. Nothing is admitted
once ``--seconds`` have passed since the window opened, and the window
closes when the last admitted request is answered. A request's time ends when its output is a NumPy array on the
host, so it includes the copy back from the card."""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import check, generator, registry, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddsp_svc_tpu")
MISSING = check.MISSING


@dataclass
class Done:
    request: generator.Request
    t0: float
    cycle: int = 0  # how many times the pool had been sent before this one
    t1: float = math.nan
    output: np.ndarray | None = None
    error: str | None = None

    @property
    def seed(self) -> int:
        """This admission's noise seed: the request's own on the pool's
        first pass, another on each later one, so that two admissions of one
        request in one batch are told apart."""
        return self.request.seed ^ (self.cycle << 40)


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cfg: dict
    mix: dict
    window_s: float
    done: list
    counters: dict
    trace: dict | None = None

    @property
    def completed(self) -> list:
        return [d for d in self.done if d.output is not None]


def drive(system, requests: list, mix: dict, seconds: float,
          gaps) -> tuple[float, float, list[Done]]:
    """The mix's arrivals for ``seconds`` -> (window opening, window close,
    every admitted request)."""
    width = int(mix["door"])
    door = threading.BoundedSemaphore(width)
    done: list[Done] = []

    def one(d: Done) -> None:
        try:
            d.output = system.serve(d.request, d.seed)
        except Exception as e:  # a request that never comes
            d.error = repr(e)
        d.t1 = time.perf_counter()
        door.release()

    t_open = time.perf_counter()
    end = t_open + seconds
    due = t_open
    with concurrent.futures.ThreadPoolExecutor(width) as pool:
        while True:
            due += gaps[len(done) % len(gaps)]
            if due >= end:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if not door.acquire(timeout=max(0.0, end - time.perf_counter())):
                break
            now = time.perf_counter()
            if now >= end:
                door.release()
                break
            d = Done(requests[len(done) % len(requests)], now, len(done) // len(requests))
            done.append(d)
            pool.submit(one, d)
    t_close = max([d.t1 for d in done] or [t_open])
    return t_open, t_close, done


def first_admissions(done: list, watch: set) -> list:
    """The first admission of each watched request, in admission order."""
    first: dict = {}
    for d in done:
        if d.request.index in watch:
            first.setdefault(d.request.index, d)
    return list(first.values())


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def end_to_end(names: list[str], window_s: float, done: list, setup_s: float,
               out_rate: int) -> dict:
    units = {"audio_s_per_s": "audio_s/s", "latency_p95_ms": "ms", "setup_s": "s"}
    ok = [d for d in done if d.output is not None]
    values = {
        "audio_s_per_s": sum(len(d.output) for d in ok) / out_rate / window_s,
        # a failed request misses every limit
        "latency_p95_ms": percentile([(d.t1 - d.t0) * 1e3 if d.output is not None
                                      else MISSING for d in done], 95.0),
        "setup_s": setup_s}
    return {n: {"value": values[n], "unit": units[n]} for n in names}


def _power_limit() -> str | None:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else None


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """-> the result line's object (without the JAX check)."""
    cfg, mix = cell["config"], cell["mix"]
    on_card = torch.device(device).type == "cuda"
    check.precision(False)
    system = cell["system"].build(cfg, mix, seed, torch.device(device))
    requests = cell["source"](mix, seed, system.sample_rate)
    gaps = generator.gaps(mix, seed)
    system.warm()
    drive(system, requests, mix, float(mix["warm_s"]), gaps)
    watch = system.watch(requests, int(mix["check"]["requests"]), seed)
    system.open_window({requests[i].seed for i in watch}, traced)
    setup_s = time.perf_counter() - t_start
    with (tracing.profiled() if traced else contextlib.nullcontext({})) as prof:
        with (tracing.window_span() if traced else contextlib.nullcontext()):
            t_open, t_close, done = drive(system, requests, mix, seconds, gaps)
    system.close_window()
    run = Run(cfg, mix, t_close - t_open, done, system.counters)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    system.release()
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result: dict = {"correct": False, "attempted": len(done),
                    "failed": sum(d.output is None for d in done)}
    if traced:
        run.trace = tracing.reduce(prof["events"])
        del prof["events"]
        metrics = {}
        for m in cell["per_layer"]:
            value = cell["readers"][m["name"]](run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
        result["layers"] = run.trace["layer_s"]
        print(f"trace: activities {run.trace['kinds']}, spans {run.trace['calls']}",
              file=sys.stderr)
    else:
        metrics = end_to_end([m["name"] for m in cell["end_to_end"]],
                             t_close - t_open, done, setup_s, system.out_rate)
    if on_card:
        dev_info["power"] = _power_limit()
    result["metrics"] = metrics
    result["device"] = dev_info
    # correctness, after the window, against the reference
    readings = system.readings(first_admissions(done, watch))
    result["correct"], result["check"] = check.judge(readings, cell["limits"],
                                                     result["failed"])
    return result


def forbidden_modules() -> list[str]:
    return sorted({n.split(".", 1)[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv: list[str], t_start: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = registry.cell(registry.benchmark(), a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"svc_bench: {a.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # one host thread a torch op: the serving threads are many already
    torch.set_num_threads(1)
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                      t_start)
    found = forbidden_modules()
    if found:
        print(f"svc_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, n in result["check"].items():
        print(f"check {name} {n['value']} limit {n['limit']}", file=sys.stderr)
    check_numbers = result.pop("check")
    result["check"] = check_numbers  # the last key of the line
    print(json.dumps(result), flush=True)
    return 0
