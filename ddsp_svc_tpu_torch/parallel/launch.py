"""Start the ranks of a world as ``torchrun --nproc_per_node N`` starts them
on one host, for callers that launch a multi-process run themselves
(``chip_smoke.py``, the tests): each rank is ``python <argv>`` with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1, ``MASTER_PORT`` a free
port; ``OMP_NUM_THREADS`` 1 unless set, as torchrun sets it for more than
one rank). The world's wall is bounded: past ``timeout`` s, or as soon as one
rank fails (the others would wait on it in a collective), every rank is
killed and the launch raises with each rank's output.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list, nproc: int, timeout: float, env: dict | None = None,
           cwd: str | None = None) -> list:
    """Run ``python *argv`` as ``nproc`` ranks -> each rank's output
    (stdout and stderr together), in rank order."""
    base = dict(os.environ if env is None else env)
    base.update(WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    if nproc > 1:
        base.setdefault("OMP_NUM_THREADS", "1")
    logs = [tempfile.TemporaryFile() for _ in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable] + list(argv), cwd=cwd, stdout=log,
        stderr=subprocess.STDOUT, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        timed_out = time.monotonic() > deadline
        raise RuntimeError(
            f"ranks exited {codes}" + (f" (killed after {timeout:.0f} s)"
                                       if timed_out else "") + "\n"
            + "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs
