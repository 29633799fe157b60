"""The traced run: spans the benchmark puts around the calls into each
layer of the port, torch.profiler over the window, and the reduction of the
profile to device time by layer, the device's busy time, the top device
operations and the longest idle gaps.

The spans are ``torch.profiler.record_function`` ranges opened by wrappers
that a cell's system (``systems/<name>.py``) installs on the port's objects
for the traced run only:
``layer.*`` around model calls (a kernel belongs to the innermost layer
span on the thread that launched it), ``host.*`` around the serving
threads' host work (what an idle gap is labelled with). The profiler drops
the device records of the first few device operations of a trace, so 64
spin kernels run inside the trace before the window and are left out of
every sum, told apart by name.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import re
from collections import defaultdict

import torch

LEAD_OPS = 64
LEAD_CYCLES = 250_000
LEAD_KERNEL = "spin_kernel"
WINDOW = "svc_bench.window"


def span(name: str):
    """A host span that the device work launched inside it links to: a
    function-scope record, which the profiler correlates with every launch
    made under it, through PyTorch or through ctypes (a user-scope
    ``record_function`` links only launches made by PyTorch ops)."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast is not None else torch.profiler.record_function(name)


def _wrap(fn, name: str):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return inner


class Spans:
    """Span wrappers a system installs on the program's objects for the
    traced run only, removed by ``close``."""

    def __init__(self):
        self._undo = []

    def on(self, obj, attr: str, name: str) -> None:
        """Wrap ``obj.attr`` (a method, or a module's function) in a span."""
        own = attr in vars(obj)
        old = getattr(obj, attr)
        setattr(obj, attr, _wrap(old, name))
        self._undo.append(lambda: setattr(obj, attr, old) if own else delattr(obj, attr))

    def on_factory(self, obj, attr: str, name: str) -> None:
        """Wrap in a span each function that the factory ``obj.attr`` makes."""
        own = attr in vars(obj)
        old = getattr(obj, attr)
        setattr(obj, attr, lambda *a: _wrap(old(*a), name))
        self._undo.append(lambda: setattr(obj, attr, old) if own else delattr(obj, attr))

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []


def _experimental():
    """Every thread's host ops: the serving threads launch the work."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option: the main thread only
        return None


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, with the spin lead traced first; yields
    a dict that holds the raw events once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_experimental())
    with prof:
        for _ in range(LEAD_OPS):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        yield out
        torch.cuda.synchronize()
    out["events"] = prof.profiler.kineto_results.events()


# the CUDA runtime's and driver's API calls, recorded on the host
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events) -> dict:
    """Raw profiler events -> {"window_s", "busy_s", "layer_s" {span: device
    seconds}, "calls" {span: count}, "device_ops" [[name, s]], "idle_gaps"
    [[label, s]], "kinds" {activity: count}} over the window span."""
    from torch.autograd import DeviceType

    ops, runtime, device, kinds = [], [], [], defaultdict(int)
    for e in events:
        if e.device_type() == DeviceType.CPU:
            (runtime if RUNTIME.match(e.name()) else ops).append(e)
        elif e.device_type() == DeviceType.CUDA:
            device.append(e)
    kinds.update(host_op=len(ops), runtime=len(runtime), device=len(device))
    win = [e for e in ops if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    spans = [e for e in ops if e.name().startswith(("layer.", "host."))
             and e.start_ns() < w1 and e.end_ns() > w0]
    calls = defaultdict(int)
    for e in spans:
        calls[e.name()] += 1
    # the op that launched each device event: (thread, launch time). A
    # kernel the port launches through ctypes has no op of its own: its
    # runtime call (same correlation id) gives the system thread and the
    # time, and the system thread maps to the profiler's thread id by the
    # runtime calls that ops made.
    launch_at = {e.correlation_id(): (e.start_thread_id(), e.start_ns()) for e in ops}
    votes: dict = defaultdict(lambda: defaultdict(int))
    for e in runtime:
        op = launch_at.get(e.linked_correlation_id())
        if op is not None:
            votes[e.start_thread_id()][op[0]] += 1
    thread_of = {sys_tid: max(v, key=v.get) for sys_tid, v in votes.items()}
    runtime_at = {e.correlation_id(): (thread_of.get(e.start_thread_id()), e.start_ns())
                  for e in runtime}
    by_thread = defaultdict(list)
    for e in spans:
        if e.name().startswith("layer."):
            by_thread[e.start_thread_id()].append((e.start_ns(), e.end_ns(), e.name()))
    for v in by_thread.values():
        v.sort()
    starts = {k: [s for s, _, _ in v] for k, v in by_thread.items()}

    def layer_of(thread: int, t: int) -> str:
        """The innermost layer span open at t on the thread: spans nest, so
        the latest-starting one that has not ended."""
        v = by_thread.get(thread, ())
        i = bisect.bisect_right(starts.get(thread, ()), t) - 1
        while i >= 0:
            if v[i][1] >= t:
                return v[i][2]
            i -= 1
        return "other"

    layer_s, op_s, busy = defaultdict(float), defaultdict(float), []
    for e in device:
        name = e.name()
        # the spin lead, and the device-side copies of the spans
        if LEAD_KERNEL in name or name.startswith(("layer.", "host.", WINDOW)):
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        busy.append((s, t))
        op_s[name[:160]] += (t - s) / 1e9
        at = launch_at.get(e.linked_correlation_id()) or runtime_at.get(e.correlation_id())
        layer_s[layer_of(*at) if at and at[0] is not None else "unlinked"] += (t - s) / 1e9
    merged = _union(busy)
    busy_s = sum(t - s for s, t in merged) / 1e9
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    if merged:
        gaps += [(merged[0][0] - w0, w0, merged[0][0]), (w1 - merged[-1][1], merged[-1][1], w1)]
    gaps = sorted(g for g in gaps if g[0] > 0)[-10:][::-1]
    host = [e for e in spans if e.name().startswith("host.")]

    def label(a: int, b: int) -> str:
        mid = (a + b) // 2
        open_ = sorted({e.name() for e in host if e.start_ns() <= mid <= e.end_ns()})
        return "+".join(open_) or "no host span (clients or the interpreter)"

    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "layer_s": dict(layer_s), "calls": dict(calls),
            "device_ops": [[n, s] for n, s in sorted(op_s.items(),
                                                     key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[label(a, b), g / 1e9] for g, a, b in gaps],
            "kinds": dict(kinds)}


def window_span():
    return span(WINDOW)

