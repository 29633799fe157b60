"""Device timing on a CUDA card, shared by ``chip_smoke.py`` and
``tools/kernel_ab.py`` (which loads this file by path, so that every copy
of the package it compares is timed by the same code).

``cuda_ms`` times back-to-back calls with CUDA events: right for a call
that keeps the card busier than the host's launch rate. ``graph_ms``
replays calls captured in one CUDA graph, for calls shorter than a host
launch. ``profiled_call`` reads torch.profiler's device time of a kernel
and counts a call's device operations; ``launch_split`` gives the device
time of each kernel a call launches; ``wall_ms`` is the host's wall time
of one call up to ``synchronize()``.
"""
from __future__ import annotations

import time

import torch


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls after a
    warm-up (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 200, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, whose replays are timed with CUDA events, so the host's launch
    rate does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n)


def profiled_call(fn, symbol: str, reps: int = 20) -> tuple[float, float, float]:
    """(device ms per launch of the kernels whose name holds ``symbol``,
    device operations per call, device ms per call of all of them) over
    ``reps`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    k_us = k_n = ops = all_us = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0) or getattr(
            evt, "self_cuda_time_total", 0)
        ops += evt.count
        all_us += us
        if symbol in evt.key:
            k_us += us
            k_n += evt.count
    if k_n == 0:
        raise RuntimeError(f"profile: no device time for {symbol}")
    return k_us / k_n / 1e3, ops / reps, all_us / reps / 1e3


def launch_split(fn, symbol: str, reps: int = 20) -> list[tuple[str, float]]:
    """[(kernel, device ms per launch)] of the kernels whose name holds
    ``symbol``, in the order one call of ``fn`` launches them, over ``reps``
    calls under torch.profiler. A lead of spin kernels goes first, since
    the profiler drops a trace's first device records, and the order is
    read from the last call, which is whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = sorted(((e.time_range.start, e) for e in prof.events()
                    if symbol in e.name and e.device_time_total > 0),
                   key=lambda pair: pair[0])
    if not found:
        raise RuntimeError(f"profile: no device time for {symbol}")
    times: dict[str, list[float]] = {}
    for _, e in found:
        times.setdefault(e.name, []).append(e.device_time_total / 1e3)
    order = []
    for _, e in reversed(found):
        if e.name in order:
            break
        order.insert(0, e.name)

    def short(name: str) -> str:
        start = name.find(symbol)
        end = name.find("(", start)
        return name[start:end if end > 0 else None]

    return [(short(n), sum(times[n]) / len(times[n])) for n in order]


def wall_ms(fn, n: int = 100) -> float:
    """Median host wall of one call of ``fn`` ending in synchronize()."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[n // 2] * 1e3
