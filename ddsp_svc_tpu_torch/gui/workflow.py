"""Training-workflow orchestration for the web GUI (mirrors
ddsp_svc_tpu/gui/workflow.py; the reference's ``webui (outdated).py:77-125``
is a gradio shell that rewrites the config YAML, then drives
``preprocess.py`` / ``train.py`` / ``tensorboard`` as subprocesses and
streams their stdout).

One :class:`JobRunner` owns at most one child process at a time (the
reference lets buttons race), reads its interleaved stdout/stderr on a
daemon thread into a bounded ring buffer, and stops by killing the exact
process group it started. Config derivation applies a whitelisted set of
``train:`` overrides (the fields the reference's ``create_config`` edits)
and writes a sibling YAML with the port's stdlib writer instead of mutating
the user's base config in place. The jobs are the port's CLIs
(``ddsp_svc_tpu_torch.cli.preprocess`` and ``.cli.train``), on the GUI's
device.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
from collections import deque

from ..utils.config import load_config, save_config

# train: fields the reference webui exposes (webui (outdated).py:82-90),
# minus the reference's DataLoader ones (num_workers, cache_device), which
# the trainer has no counterpart of; env.expdir added so runs can be kept
# apart from the GUI.
CONFIG_OVERRIDES = {
    "batch_size": int,
    "lr": float,
    "epochs": int,
    "cache_all_data": bool,
    "expdir": str,
}

JOB_KINDS = ("preprocess", "train", "tensorboard")

LOG_LINES = 2000


def derive_config(base_path: str, overrides: dict) -> str:
    """Apply whitelisted train overrides to ``base_path`` and write the
    result next to it as ``<stem>.gui.yaml``; returns the new path."""
    raw = dict(load_config(base_path))
    for key, value in overrides.items():
        if key not in CONFIG_OVERRIDES or value in (None, ""):
            continue
        caster = CONFIG_OVERRIDES[key]
        if caster is bool:
            value = value in (True, "true", "True", "1", 1)
        else:
            value = caster(value)
        if key == "expdir":
            raw.setdefault("env", {})["expdir"] = value
        else:
            raw.setdefault("train", {})[key] = value
    stem, _ = os.path.splitext(base_path)
    out_path = stem + ".gui.yaml"
    save_config(out_path, raw)
    return out_path


def job_argv(kind: str, config_or_dir: str, device: str | None = None
             ) -> list[str]:
    """Command line for a workflow job: the port's preprocess and train
    CLIs (with ``--device`` when one is given; without, they take the
    card). Module-level so tests can swap it for a stub command;
    tensorboard rides the wheel's ``-m`` entry (no console script)."""
    if kind in ("preprocess", "train"):
        return ([sys.executable, "-m", f"ddsp_svc_tpu_torch.cli.{kind}",
                 "-c", config_or_dir]
                + (["--device", str(device)] if device is not None else []))
    if kind == "tensorboard":
        # the GUI hands over the config YAML; tensorboard wants the
        # experiment dir the trainer logs into (config env.expdir)
        logdir = config_or_dir
        if os.path.isfile(logdir):
            try:
                cfg = load_config(logdir)
                logdir = cfg.env.expdir
            except Exception:
                pass  # fall back to the raw argument (may be a dir)
        return [sys.executable, "-m", "tensorboard.main",
                "--logdir", logdir, "--port", "6006",
                "--bind_all"]
    raise ValueError(f"unknown job kind: {kind}")


class JobRunner:
    """At most one child process; log lines in a bounded ring buffer.

    ``poll(since)`` returns only lines past a sequence cursor so the page
    can poll cheaply; ``stop()`` signals the exact process group started
    here (never a pattern match)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._proc: subprocess.Popen | None = None
        self._kind: str | None = None
        self._returncode: int | None = None
        self._lines: deque[tuple[int, str]] = deque(maxlen=LOG_LINES)
        self._seq = 0
        self._gen = 0  # job generation: stale pumps must not touch the log

    def start(self, kind: str, argv: list[str], cwd: str | None = None):
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                raise RuntimeError(f"a {self._kind} job is still running")
            self._kind = kind
            self._returncode = None
            self._lines.clear()
            self._seq = 0
            self._gen += 1
            # the package may be run from a checkout rather than installed:
            # prepend its parent dir so `-m ddsp_svc_tpu_torch.cli.*`
            # resolves in the child regardless of the server's cwd (keeps
            # any existing PYTHONPATH entries)
            env = dict(os.environ)
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env["PYTHONPATH"] = os.pathsep.join(
                [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                              else []))
            self._proc = subprocess.Popen(
                argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, bufsize=1,
                start_new_session=True,
            )
            threading.Thread(
                target=self._pump, args=(self._proc, self._gen), daemon=True
            ).start()

    def _pump(self, proc: subprocess.Popen, gen: int):
        for line in proc.stdout:
            with self._lock:
                if self._gen != gen:
                    break  # a newer job owns the log; drop the stale tail
                self._lines.append((self._seq, line.rstrip("\n")))
                self._seq += 1
        proc.stdout.close()
        rc = proc.wait()
        with self._lock:
            if self._gen == gen:
                self._returncode = rc

    def stop(self, timeout: float = 10.0):
        with self._lock:
            proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()

    def poll(self, since: int = 0) -> dict:
        with self._lock:
            running = self._proc is not None and self._proc.poll() is None
            lines = [ln for seq, ln in self._lines if seq >= since]
            next_seq = self._seq
            return {
                "running": running,
                "kind": self._kind,
                "returncode": self._returncode,
                "lines": lines,
                "next": next_seq,
            }
