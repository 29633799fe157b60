"""The time axis as a ``torch.distributed`` world (the counterpart of
ddsp_svc_tpu/parallel/mesh.py ``make_mesh`` and of ``shard_map``'s
collectives for the streamed drivers).

JAX runs one controller over a mesh of devices; the port runs one process
per time block. Rank r of a world of N holds frames [r T / N, (r + 1) T /
N) of an utterance and computes on ``cuda:{r % device_count}`` (several
ranks share a card when N exceeds the cards; that is said on stderr), or
on the CPU when the caller asks for it. The backend is gloo with a
``file://`` rendezvous in a fresh temporary directory (no TCP port to
collide with another world on the machine). gloo moves host tensors only,
so every collective here stages its tensors through the host: ``.cpu()``
before, ``.to(device)`` after. A collective that fails raises; nothing
falls back to a local answer.

``TimeGroup`` holds one rank's view: the two ring shifts (JAX ``ppermute``
to the right and to the left neighbour, without the wrap-around that the
drivers mask away), ``psum``, ``all_gather``, and the scatter and gather
of whole arrays on rank 0 (``shard_map``'s ``in_specs`` and
``out_specs``).

``World`` is rank 0 in the calling process and starts ranks 1 .. N - 1 as
helper processes (``python -m ddsp_svc_tpu_torch.parallel.mesh``). A
helper imports nothing but the port: it receives each model once, pickled
(``World.share``), and then runs every streamed entry point that rank 0
runs (``World.call``) with ``None`` in place of the whole arrays, which
the entry point scatters from rank 0. A helper ends at ``World.close`` or
when a collective fails. Helpers take rank 0's TF32 settings (matmul
precision, cuDNN's TF32), so every rank computes as rank 0 does, and the
ranks split rank 0's intra-op threads between them while the world lives.

The data-parallel helpers of JAX's mesh.py (``shard_batch``,
``batch_sharding``, ``replicate``) belong to multi-process training and
are not here yet.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import importlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent.parent
PACKAGE = Path(__file__).resolve().parent.parent.name  # also when run as __main__
TIMEOUT_S = 300.0  # a collective's limit
_TAG_RIGHT, _TAG_LEFT = 1, 2  # messages moving up / down the ranks


def rank_device(rank: int, device: str | torch.device | None = None
                ) -> torch.device:
    """Rank ``rank``'s device: the CPU when ``device`` names it, else
    ``cuda:{rank % device_count}``. Without a card and without
    ``device='cpu'`` it raises: no rank moves to the CPU unasked."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy for gloo (complex as its real view)."""
    x = x.detach()
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.to("cpu").contiguous()


def _back(t: torch.Tensor, like: torch.Tensor | None, complex_: bool,
          device: torch.device) -> torch.Tensor:
    if complex_:
        t = torch.view_as_complex(t)
    return t.to(device if like is None else like.device)


class TimeGroup:
    """One rank's handle on the time axis of a world of ``size`` ranks."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank, self.size, self.device = rank, size, torch.device(device)

    @contextlib.contextmanager
    def _failing(self, what: str):
        """Any error of the collective (a dead or hung peer) raised as this
        rank's RuntimeError."""
        try:
            yield
        except Exception as e:
            raise RuntimeError(f"time group rank {self.rank}/{self.size}: "
                               f"{what} failed: {e}") from e

    def _wait(self, make_works, what: str) -> None:
        with self._failing(what):
            for w in make_works():
                w.wait()

    def exchange(self, to_right: torch.Tensor | None,
                 to_left: torch.Tensor | None):
        """Send ``to_right`` to rank + 1 and ``to_left`` to rank - 1 ->
        (what rank - 1 sent right, what rank + 1 sent left), None past the
        ends of the axis. Each rank sends and receives tensors of the same
        shape (equal blocks), so a receive takes its send's shape."""
        r, n = self.rank, self.size
        got, sent = {}, []  # the buffers live until every wait returns

        def works():
            out = []
            for x, peer_out, peer_in, tag, key in (
                    (to_right, r + 1, r - 1, _TAG_RIGHT, "left"),
                    (to_left, r - 1, r + 1, _TAG_LEFT, "right")):
                if x is None:
                    continue
                h = _host(x)
                if 0 <= peer_out < n:
                    sent.append(h)
                    out.append(dist.isend(h, peer_out, tag=tag))
                if 0 <= peer_in < n:
                    got[key] = (torch.empty_like(h), x)
                    out.append(dist.irecv(got[key][0], peer_in, tag=tag))
            return out

        self._wait(works, "halo exchange")
        out = {k: _back(buf, x, x.is_complex(), self.device)
               for k, (buf, x) in got.items()}
        return out.get("left"), out.get("right")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in rank order."""
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        with self._failing("all_gather"):
            dist.all_gather(parts, h)
        return _back(torch.stack(parts), x, x.is_complex(), self.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, added in rank order (the same value
        on every rank)."""
        parts = self.all_gather(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def broadcast_object(self, obj=None):
        """Rank 0's picklable ``obj`` on every rank."""
        box = [obj]
        with self._failing("broadcast"):
            dist.broadcast_object_list(box, src=0)
        return box[0]

    def broadcast(self, x: torch.Tensor | None) -> torch.Tensor | None:
        """Rank 0's tensor (or None) on every rank's device (``P()``)."""
        meta = self.broadcast_object(
            None if self.rank or x is None
            else (tuple(_host(x).shape), _host(x).dtype, x.is_complex()))
        if meta is None:
            return None
        shape, dtype, complex_ = meta
        buf = _host(x) if self.rank == 0 else torch.empty(shape, dtype=dtype)
        with self._failing("broadcast"):
            dist.broadcast(buf, src=0)
        if self.rank == 0:
            return x.to(self.device)
        return _back(buf, None, complex_, self.device)

    def scatter(self, pieces: list | None) -> torch.Tensor:
        """Rank 0's ``pieces`` (one tensor per rank, any shapes) -> this
        rank's piece on its device."""
        if self.rank == 0:
            if len(pieces) != self.size:
                raise ValueError(f"scatter: {len(pieces)} pieces for "
                                 f"{self.size} ranks")
            hosts = [_host(p) for p in pieces]
            meta = [(tuple(h.shape), h.dtype, p.is_complex())
                    for h, p in zip(hosts, pieces)]
        meta = self.broadcast_object(meta if self.rank == 0 else None)
        if self.rank == 0:
            self._wait(lambda: [dist.isend(h, r) for r, h in enumerate(hosts)
                                if r], "scatter")
            return pieces[0].to(self.device)
        shape, dtype, complex_ = meta[self.rank]
        buf = torch.empty(shape, dtype=dtype)
        self._wait(lambda: [dist.irecv(buf, 0)], "scatter")
        return _back(buf, None, complex_, self.device)

    def scatter_blocks(self, x: torch.Tensor | None, dim: int = 1
                       ) -> torch.Tensor:
        """Rank 0's x cut into ``size`` equal blocks along ``dim`` -> this
        rank's block (``P(None, axis)``)."""
        if self.rank == 0:
            if x.shape[dim] % self.size:
                raise ValueError(f"scatter: length {x.shape[dim]} is not a "
                                 f"multiple of {self.size} ranks")
            return self.scatter(list(torch.chunk(x, self.size, dim=dim)))
        return self.scatter(None)

    def gather_blocks(self, x: torch.Tensor, dim: int = 1
                      ) -> torch.Tensor | None:
        """Every rank's block joined along ``dim`` on rank 0 (None on the
        others)."""
        h = _host(x)
        if self.rank:
            self._wait(lambda: [dist.isend(h, 0)], "gather")
            return None
        bufs = [torch.empty_like(h) for _ in range(self.size - 1)]
        self._wait(lambda: [dist.irecv(b, r + 1) for r, b in enumerate(bufs)],
                   "gather")
        parts = [x] + [_back(b, x, x.is_complex(), self.device) for b in bufs]
        return torch.cat(parts, dim=dim)

    def gather_object(self, obj) -> list | None:
        """Every rank's picklable ``obj`` in rank order on rank 0."""
        out = [None] * self.size if self.rank == 0 else None
        with self._failing("gather"):
            dist.gather_object(obj, out, dst=0)
        return out


def init_rank(rank: int, size: int, init_file: str, device) -> TimeGroup:
    """Join the gloo world at ``init_file`` as ``rank`` -> its TimeGroup."""
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return TimeGroup(rank, size, rank_device(rank, device))


def _counters() -> dict:
    """The kernel wrappers whose ``launches`` a rank counts."""
    from ..ops.cuda_conformer import (conformer_layer, conformer_layer_bf16,
                                      conformer_layer_bf16_io)
    from ..ops.cuda_oscillator import harmonic_bank
    from ..ops.cuda_resblock import resblock_group, resblock_group_bf16
    from ..ops.cuda_source import combtooth

    return {f.__name__: f for f in (
        combtooth, resblock_group, resblock_group_bf16, conformer_layer,
        conformer_layer_bf16, conformer_layer_bf16_io, harmonic_bank)}


def launch_counts() -> dict:
    return {name: f.launches for name, f in _counters().items()}


def reset_launch_counts() -> None:
    for f in _counters().values():
        f.launches = 0


def _resolve(target: str):
    """'module:qualified.name' -> the object, in a helper. A helper runs
    only code that imports no JAX: a target whose import brings JAX in (a
    test module's function, say) raises."""
    module, _, name = target.partition(":")
    obj = importlib.import_module(module)
    if "jax" in sys.modules:
        raise ValueError(f"{target!r}: importing {module} brought in JAX; "
                         "a helper rank runs the port's code only")
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _target(fn) -> str:
    """``fn``'s importable name (a helper cannot import the caller's main
    script)."""
    if fn.__module__ == "__main__":
        raise ValueError(f"{fn.__qualname__}: a helper rank cannot import "
                         "a function of the main script")
    return f"{fn.__module__}:{fn.__qualname__}"


_REF = "\0ref"  # marks an argument that a helper rebuilds


def _load_module(blob: bytes, device: torch.device):
    return torch.load(io.BytesIO(blob), map_location=device, weights_only=False)


def follow(group: TimeGroup) -> None:
    """A helper rank's loop: take rank 0's messages until 'stop'."""
    modules = {}

    def decode(v):
        if isinstance(v, tuple) and len(v) == 3 and v[0] == _REF:
            return modules[v[2]] if v[1] == "module" else _resolve(v[2])
        return v

    while True:
        msg = group.broadcast_object(None)
        op = msg[0]
        if op == "stop":
            return
        if op == "share":
            modules[msg[1]] = _load_module(msg[2], group.device)
        elif op == "call":
            _, target, args, kwargs = msg
            with torch.no_grad():
                _resolve(target)(*map(decode, args), group=group,
                                 **{k: decode(v) for k, v in kwargs.items()})
        elif op == "launches":
            group.gather_object(launch_counts())
        elif op == "reset":
            reset_launch_counts()
        else:
            raise ValueError(f"unknown message {op!r}")


class World:
    """Rank 0 of a world of ``size`` ranks in this process, ranks 1 .. size
    - 1 as helper processes on ``rank_device(r, device)``. Use as a context
    manager (``close`` stops the helpers).

    The ranks split this process's intra-op threads (by default one per
    core): each takes max(1, threads // size), rank 0 until ``close``, so N
    ranks on the CPU do not each spin a thread on every core."""

    def __init__(self, size: int, device: str | torch.device | None = None):
        if size < 1:
            raise ValueError(f"world size {size} < 1")
        self.size = size
        dev = rank_device(0, device)
        self.device_arg = "cpu" if dev.type == "cpu" else "cuda"
        if dev.type == "cuda":
            if size > torch.cuda.device_count():
                print(f" [!] {size} ranks share {torch.cuda.device_count()} "
                      "CUDA card(s): halos cross the host", file=sys.stderr)
            from ..ops import kernels

            kernels.library()  # build once here, not in every rank
        self._threads = torch.get_num_threads()
        threads = max(1, self._threads // size)
        torch.set_num_threads(threads)
        self._tmp = tempfile.mkdtemp(prefix="ddsp_world_")
        init_file = os.path.join(self._tmp, "rendezvous")
        env = dict(os.environ)
        # the helpers import what this process can (multiprocessing's spawn
        # passes sys.path the same way)
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
            [str(ROOT)] + [os.path.abspath(p) for p in sys.path]))
        # the helpers compute as this process does: TF32 as it is set here
        precision = [
            "--matmul_precision", torch.get_float32_matmul_precision(),
            "--cudnn_tf32", str(int(torch.backends.cudnn.allow_tf32))]
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGE}.parallel.mesh", "--rank",
             str(r), "--size", str(size), "--init", init_file, "--device",
             self.device_arg, "--threads", str(threads)] + precision,
            env=env, cwd=str(ROOT)) for r in range(1, size)]
        self._shared = {}
        self.group = None
        try:
            self.group = init_rank(0, size, init_file, self.device_arg)
        except BaseException:
            self._kill()
            raise

    @property
    def device(self) -> torch.device:
        return self.group.device

    def share(self, module: torch.nn.Module) -> int:
        """Send ``module`` to every helper once -> its key."""
        entry = self._shared.get(id(module))
        if entry is None:
            buf = io.BytesIO()
            torch.save(module, buf)
            key = len(self._shared)
            self.group.broadcast_object(("share", key, buf.getvalue()))
            entry = self._shared[id(module)] = (key, module)
        return entry[0]

    def _encode(self, v):
        if isinstance(v, torch.nn.Module):
            return (_REF, "module", self.share(v))
        if isinstance(v, (torch.Tensor, torch.Generator)):
            return None  # rank 0's data and draws
        if callable(v):
            return (_REF, "fn", _target(v))
        return v

    def call(self, fn, *args, **kwargs):
        """``fn(*args, group=, **kwargs)`` on every rank: here as given, on
        the helpers with None for each tensor (rank 0's data, which ``fn``
        scatters) and generator, each module shared first, each function
        by its name in the port."""
        remote = ([self._encode(a) for a in args],
                  {k: self._encode(v) for k, v in kwargs.items()})
        self.group.broadcast_object(("call", _target(fn)) + remote)
        return fn(*args, group=self.group, **kwargs)

    def launches(self) -> list:
        """Each rank's kernel launch counts, in rank order."""
        self.group.broadcast_object(("launches",))
        return self.group.gather_object(launch_counts())

    def reset_launches(self) -> None:
        self.group.broadcast_object(("reset",))
        reset_launch_counts()

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(self._tmp, ignore_errors=True)
        torch.set_num_threads(self._threads)

    def close(self) -> None:
        """Stop the helpers and leave the world; a helper that failed
        makes this raise."""
        try:
            if self.group is not None and dist.is_initialized():
                self.group.broadcast_object(("stop",))
            codes = []
            for p in self._procs:
                try:
                    codes.append(p.wait(timeout=60))
                except subprocess.TimeoutExpired:
                    codes.append(None)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            self._kill()
            self.group = None
        if any(c != 0 for c in codes):
            raise RuntimeError(f"a helper rank failed (exit codes {codes})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:  # the run already failed: stop the helpers, keep its error
            try:
                if dist.is_initialized():
                    dist.destroy_process_group()
            finally:
                self._kill()
                self.group = None
        return False


def _main(argv=None) -> None:
    p = argparse.ArgumentParser(description="A helper rank of a World.")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--matmul_precision", default="highest")
    p.add_argument("--cudnn_tf32", type=int, default=0)
    a = p.parse_args(argv)
    torch.set_num_threads(max(1, a.threads))
    torch.set_float32_matmul_precision(a.matmul_precision)
    torch.backends.cudnn.allow_tf32 = bool(a.cudnn_tf32)
    group = init_rank(a.rank, a.size, a.init, a.device)
    try:
        follow(group)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
