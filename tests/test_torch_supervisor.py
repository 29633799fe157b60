"""The recycling worker supervisor of the port's HTTP server
(ddsp_svc_tpu_torch/cli/api.py ``_strip_supervisor_args``, ``_Supervisor``,
``main`` with ``--worker_max_requests`` / ``--worker_max_rss_mb``) on the
CPU:

- ``_strip_supervisor_args`` against JAX's over argv spellings;
- against a stub worker (tests/torch_api_stub_worker.py, through the
  ``worker_module`` seam): a recycle after N connections with the old
  worker terminated, a connection in flight drained before its worker
  ends, a recycle on the resident-memory cap alone, ``shutdown`` ending a
  replacement still starting, and a parent that makes no CUDA call and
  loads no model;
- one real supervised ``cli.api`` (``--device cpu``) on a JAX checkpoint
  that recycles every 2 connections and answers 6 POSTs, as JAX's
  tests/test_api.py:427 does, each response closing its connection.
"""
import io
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
from scipy.io import wavfile

from ddsp_svc_tpu.cli.api import _strip_supervisor_args as jax_strip
from ddsp_svc_tpu_torch.cli import api
from test_torch_api import _post, _wav_bytes
from test_torch_cli import ddsp_ckpt  # noqa: F401 (a fixture)

STUB = "torch_api_stub_worker"


@pytest.mark.parametrize("argv", [
    ["-m", "exp/model_1.ckpt"],
    ["-m", "m", "--worker_max_requests", "3"],
    ["-m", "m", "--worker_max_requests=3", "-p", "7000", "--batch", "4"],
    ["--port=7000", "--worker_max_rss_mb", "900", "-m", "m", "--device", "cpu"],
    ["-p=1", "--_port_file", "/tmp/x", "--batch_devices", "2", "-m", "m"],
    ["--_port_file=/tmp/x", "--worker_max_rss_mb=5", "--host", "0.0.0.0", "-m", "m"],
    ["-m", "m", "--port", "6842", "--worker_max_requests", "2", "--worker_max_rss_mb", "1"],
])
def test_strip_supervisor_args_matches_jax(argv):
    got = api._strip_supervisor_args(list(argv))
    assert got == jax_strip(list(argv))
    assert not {"-p", "--port", "--worker_max_requests", "--worker_max_rss_mb",
                "--_port_file"} & set(got)


def _get(port: int, path: str = "/health") -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def _post_pid(port: int, path: str = "/") -> int:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=b"x",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Connection"] == "close"
        return int(r.read())


def _wait(cond, seconds: float = 30.0, what: str = "") -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out: {what}")
        time.sleep(0.05)


@pytest.fixture
def stub(monkeypatch):
    """A supervisor over the stub worker, serving in a thread; shut down
    (every worker ended) after the test."""
    monkeypatch.setattr(api._Supervisor, "worker_module", STUB)
    made = []

    def start(max_requests=2, **kw):
        sup = api._Supervisor(0, ["-m", "unused"], max_requests, host="127.0.0.1",
                              spawn_timeout_s=60.0, **kw)
        th = threading.Thread(target=sup.serve_forever, daemon=True)
        th.start()
        made.append((sup, th))
        port = sup.server_address[1]
        _wait(lambda: sup._current is not None, what="the first worker")
        return sup, port

    yield start
    for sup, th in made:
        sup.shutdown()
        th.join(30)
        assert not th.is_alive()


def _serving(sup) -> int:
    """The generation taking new connections."""
    with sup._lock:
        return sup._current["gen"]


def _ended(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_recycles_after_n_connections(stub):
    sup, port = stub(max_requests=2)
    pids = [_post_pid(port) for _ in range(2)]
    assert pids[0] == pids[1] == sup.history[0]["pid"]
    _wait(lambda: _serving(sup) == 2, what="a recycle")
    fresh = _post_pid(port)
    assert fresh != pids[0] and fresh == sup.history[1]["pid"]
    _wait(lambda: _ended(pids[0]), what="the old worker's end")
    first = sup.history[0]
    assert first["served"] == 2 and first["rss_mb"] > 0 and first["spawn_s"] > 0
    assert sup.history[1]["served"] is None  # still serving


def test_drains_a_connection_in_flight(stub):
    """The second connection is slow (1.5 s) and triggers the recycle: its
    worker answers it before it is ended, and the next connections go to
    the fresh worker."""
    sup, port = stub(max_requests=2)
    first = _post_pid(port)
    slow = {}
    th = threading.Thread(target=lambda: slow.setdefault("pid", _post_pid(port, "/slow")))
    th.start()
    _wait(lambda: _serving(sup) == 2, what="a recycle")
    assert not _ended(first)  # still draining the slow connection
    th.join(30)
    assert slow["pid"] == first
    _wait(lambda: _ended(first), what="the drained worker's end")
    assert _post_pid(port) == sup.history[1]["pid"]


def test_recycles_on_the_rss_cap_alone(stub, monkeypatch):
    monkeypatch.setattr(api._Supervisor, "rss_poll_s", 0.05)
    sup, port = stub(max_requests=float("inf"), max_rss_mb=1)
    _wait(lambda: _serving(sup) >= 2, what="an RSS recycle")
    assert sup.history[0]["rss_mb"] >= 1 and sup.history[0]["served"] == 0
    assert _get(port) == b'{"status": "ok"}'


def test_shutdown_ends_a_replacement_still_starting(stub, tmp_path, monkeypatch):
    marker = tmp_path / "slow"
    monkeypatch.setenv("STUB_WORKER_SLOW_START", str(marker))
    sup, port = stub(max_requests=1)
    marker.write_text("")
    first = _post_pid(port)
    _wait(lambda: sup._spawn_proc is not None, what="the replacement's spawn")
    spawning = sup._spawn_proc.pid
    t0 = time.monotonic()
    sup.shutdown()
    _wait(lambda: _ended(first) and _ended(spawning), seconds=40,
          what="every worker ended")
    assert time.monotonic() - t0 < 40 and sup.generations == 1


def test_the_parent_loads_no_model_and_makes_no_cuda_call(monkeypatch):
    """``main`` with a supervisor flag: nothing in the parent resolves a
    device, loads the pipeline or asks torch.cuda anything."""
    import torch

    def refuse(*a, **k):
        raise AssertionError("the supervisor's process touched CUDA or a model")

    for name in ("is_available", "device_count", "current_device", "init",
                 "set_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    import ddsp_svc_tpu_torch.infer.pipeline as pipeline
    monkeypatch.setattr(pipeline.SvcPipeline, "__init__", refuse)
    monkeypatch.setattr(api._Supervisor, "worker_module", STUB)
    holder, ready = {}, threading.Event()
    th = threading.Thread(target=api.main, daemon=True, kwargs=dict(
        argv=["-m", "absent.ckpt", "-p", "0", "--host", "127.0.0.1",
              "--worker_max_requests", "1"],
        ready_cb=lambda s: (holder.setdefault("sup", s), ready.set())))
    th.start()
    assert ready.wait(30)
    sup = holder["sup"]
    try:
        assert isinstance(sup, api._Supervisor)
        _wait(lambda: sup._current is not None, what="the first worker")
        assert _post_pid(sup.server_address[1]) == sup.history[0]["pid"]
        _wait(lambda: _serving(sup) == 2, what="a recycle")
    finally:
        sup.shutdown()
        th.join(30)
    assert not th.is_alive()


def test_supervised_cli_api_recycles_on_the_cpu(ddsp_ckpt):  # noqa: F811
    """``cli.api`` on a JAX checkpoint with ``--worker_max_requests 2``:
    every POST answered across a recycle, the generation advancing and the
    service answering after the swap."""
    holder, ready = {}, threading.Event()
    th = threading.Thread(target=api.main, daemon=True, kwargs=dict(
        argv=["-m", str(ddsp_ckpt), "-p", "0", "--host", "127.0.0.1",
              "--device", "cpu", "--worker_max_requests", "2"],
        ready_cb=lambda s: (holder.setdefault("sup", s), ready.set())))
    th.start()
    assert ready.wait(60)
    sup = holder["sup"]
    base = f"http://127.0.0.1:{sup.server_address[1]}"
    try:
        _wait(lambda: sup._current is not None, seconds=120, what="the first worker")
        wav, n_in = _wav_bytes(), int(0.25 * 16000)
        for i in range(6):
            status, payload, headers = _post(base, sample=wav)
            assert status == 200, i
            assert headers["Connection"] == "close"
            sr, data = wavfile.read(io.BytesIO(payload))
            assert abs(len(data) - n_in) <= 64 and np.any(data != 0), i
        # the old worker takes connections until its successor is healthy
        _wait(lambda: _serving(sup) >= 2, seconds=120, what="a recycle")
        assert _post(base, sample=wav)[0] == 200
        done = [h for h in sup.history if h["served"] is not None]
        assert done and all(h["served"] >= 2 for h in done)
    finally:
        sup.shutdown()
        th.join(60)
    assert not th.is_alive()
    assert all(_ended(h["pid"]) for h in sup.history)


def test_a_terminated_supervisor_ends_its_worker(ddsp_ckpt):  # noqa: F811
    """``python -m ddsp_svc_tpu_torch.cli.api --worker_max_requests 2`` as
    its own process: SIGTERM ends the supervisor and its worker with it."""
    import re
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-m", "ddsp_svc_tpu_torch.cli.api", "-m", str(ddsp_ckpt),
         "-p", "0", "--host", "127.0.0.1", "--device", "cpu",
         "--worker_max_requests", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    worker = None
    try:
        for line in proc.stdout:
            found = re.search(r"supervised API on :(\d+) \(worker pid (\d+), "
                              r"healthy after [\d.]+ s", line)
            if found:
                worker = int(found.group(2))
                break
        assert worker is not None and not _ended(worker)
        port = int(found.group(1))
        assert _get(port) == b'{"status": "ok"}'
        proc.terminate()
        assert proc.wait(60) == 0
        _wait(lambda: _ended(worker), what="the worker's end")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if worker is not None and not _ended(worker):
            os.kill(worker, 9)
