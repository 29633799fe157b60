"""The time axis as a ``torch.distributed`` world (the counterpart of
ddsp_svc_tpu/parallel/mesh.py ``make_mesh`` and of ``shard_map``'s
collectives for the streamed drivers).

JAX runs one controller over a mesh of devices; the port runs one process
per time block. Rank r of a world of N holds frames [r T / N, (r + 1) T /
N) of an utterance and computes on ``cuda:{r % device_count}`` (several
ranks share a card when N exceeds the cards; that is said on stderr), or
on the CPU when the caller asks for it. The rendezvous is a ``file://`` in
a fresh temporary directory (no TCP port to collide with another world on
the machine). ``world_backend`` picks the backend: NCCL when every rank
holds a card of its own (the world no larger than the cards, the ranks
not on the CPU), gloo otherwise (ranks that share a card, CPU worlds); the
choice is said on stderr, as the card sharing is. On NCCL the collectives
move the device tensors themselves; gloo moves host tensors only, so there
every collective stages its tensors through the host: ``.cpu()`` before,
``.to(device)`` after. Complex tensors travel as their real view on both.
A collective that fails raises; nothing falls back to a local answer, nor
from NCCL to gloo.

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

Training (``train/``, ``parallel/train_sp.py``) runs one process per rank
too, launched by ``torchrun`` (or anything that sets its environment:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
``join_launched_world``). ``make_mesh(dp, sp)`` lays the world out as JAX's
(data, time) mesh, rank = d sp + s, and gives each rank a ``TimeGroup`` on
each axis (``dist.new_group``) and one on the whole world. ``shard_batch``
and ``batch_sharding`` cut a rank's block out of a global batch, which
every rank holds (JAX's ``batch_sharding`` / ``shard_batch``), and
``replicate`` makes every rank hold rank 0's parameters and buffers
(JAX's replicated ``P()``).

Under autograd the collectives are differentiable (``torch.autograd.
Function``s): the halo exchange's backward is the reverse exchange, the
sum's is the sum, the gather's the rank's slice of the summed gradient.
Each rank's backward then issues the same collectives in the same order,
which holds as long as every rank builds the same graph: the drivers
select with masks where the ranks differ, never with branches.
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
# a training world's: its ranks wait at a barrier while rank 0 saves and
# validates, which takes minutes on a full validation set
TRAIN_TIMEOUT_S = 3600.0
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


def world_backend(size: int, device: str | torch.device | None = None) -> str:
    """The backend of a world of ``size`` ranks on ``device`` ('cpu', or a
    card as ``rank_device`` gives one): 'nccl' when each rank holds a card
    of its own, 'gloo' when ranks share a card or run on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available() or size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _say_backend(backend: str, size: int) -> None:
    print(f" [*] a world of {size} rank(s) on {backend}", file=sys.stderr)


def _wire_tensor(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy on ``device`` (complex as its real view): the CPU
    for gloo, the rank's card for NCCL."""
    x = x.detach()
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.to(device).contiguous()


def _back(t: torch.Tensor, like: torch.Tensor | None, complex_: bool,
          device: torch.device) -> torch.Tensor:
    if complex_:
        t = torch.view_as_complex(t)
    return t.to(device if like is None else like.device)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


class _Exchange(torch.autograd.Function):
    """``TimeGroup.exchange`` under autograd; a direction that sends
    nothing gives an empty output."""

    @staticmethod
    def forward(ctx, group, to_right, to_left):
        left, right = group._exchange(to_right, to_left)
        ctx.group = group
        ctx.sent = (to_right is not None, to_left is not None)
        empty = next(x for x in (to_right, to_left) if x is not None).new_zeros(0)
        return (empty if left is None else left,
                empty if right is None else right)

    @staticmethod
    def backward(ctx, g_left, g_right):
        sent_right, sent_left = ctx.sent
        # each halo's gradient goes back to the rank it came from: the left
        # halo's to rank - 1, the right halo's to rank + 1
        from_left, from_right = ctx.group._exchange(
            g_right if sent_left else None, g_left if sent_right else None)
        return None, from_right, from_left


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group._psum(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group._psum(g)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group._psum(g)[ctx.group.rank]


class TimeGroup:
    """One rank's handle on one axis of ranks: the time axis of a stream,
    or the data or time axis of a training mesh. ``rank`` and ``size`` are
    the axis's; ``ranks`` the world ranks on it in axis order and ``pg``
    its process group (None: the whole world, the default group)."""

    def __init__(self, rank: int, size: int, device: torch.device, pg=None,
                 ranks=None):
        self.rank, self.size, self.device = rank, size, torch.device(device)
        self.pg = pg
        self.ranks = list(range(size)) if ranks is None else list(ranks)
        # NCCL moves the device tensors; gloo copies through the host
        self.nccl = (dist.is_initialized()
                     and dist.get_backend(pg) == dist.Backend.NCCL)

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """x as the backend moves it (complex as its real view)."""
        return _wire_tensor(x, self.device if self.nccl else "cpu")

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           device=self.device if self.nccl else "cpu")

    def _p2p(self, ops: list) -> list:
        """Point-to-point ``(send?, tensor, world rank, tag)`` ops -> their
        works; on NCCL as one batch, so no order of the calls can leave a
        pair of ranks waiting on each other."""
        if self.nccl:
            return dist.batch_isend_irecv([
                dist.P2POp(dist.isend if send else dist.irecv, t, peer,
                           group=self.pg, tag=tag)
                for send, t, peer, tag in ops]) if ops else []
        return [(dist.isend if send else dist.irecv)(t, peer, group=self.pg, tag=tag)
                for send, t, peer, tag in ops]

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
        (what rank - 1 sent right, what rank + 1 sent left); past the ends
        of the axis, zeros (None for a direction that sends nothing). Each
        rank sends and receives tensors of the same shape (equal blocks),
        so a receive takes its send's shape."""
        if _wants_grad(to_right, to_left):
            left, right = _Exchange.apply(self, to_right, to_left)
            return (left if to_right is not None else None,
                    right if to_left is not None else None)
        return self._exchange(to_right, to_left)

    def _exchange(self, to_right, to_left):
        r, n = self.rank, self.size
        got, sent = {}, []  # the buffers live until every wait returns

        def works():
            ops = []
            for x, peer_out, peer_in, tag, key in (
                    (to_right, r + 1, r - 1, _TAG_RIGHT, "left"),
                    (to_left, r - 1, r + 1, _TAG_LEFT, "right")):
                if x is None:
                    continue
                h = self._wire(x)
                if 0 <= peer_out < n:
                    sent.append(h)
                    ops.append((True, h, self.ranks[peer_out], tag))
                if 0 <= peer_in < n:
                    got[key] = (torch.empty_like(h), x)
                    ops.append((False, got[key][0], self.ranks[peer_in], tag))
            return self._p2p(ops)

        self._wait(works, "halo exchange")
        out = {k: _back(buf, x, x.is_complex(), self.device)
               for k, (buf, x) in got.items()}

        def halo(key, sent):  # a halo has the shape of the block sent away
            if sent is None:
                return None
            return out[key] if key in out else torch.zeros_like(sent)

        return halo("left", to_right), halo("right", to_left)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in rank order."""
        if _wants_grad(x):
            return _AllGather.apply(self, x)
        return self._all_gather(x)

    def _all_gather(self, x):
        if self.size == 1:
            return x[None]
        h = self._wire(x)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        with self._failing("all_gather"):
            dist.all_gather(parts, h, group=self.pg)
        return _back(torch.stack(parts), x, x.is_complex(), self.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, added in rank order (the same value
        on every rank)."""
        if _wants_grad(x):
            return _PSum.apply(self, x)
        return self._psum(x)

    def _psum(self, x):
        parts = self._all_gather(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def psum_flat(self, tensors: list) -> list:
        """``psum`` of every tensor of ``tensors`` (one dtype) through one
        flattened buffer: one collective however many tensors."""
        flat = self._psum(torch.cat([t.reshape(-1) for t in tensors]))
        return [p.view_as(t) for p, t in
                zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]

    def barrier(self) -> None:
        if self.size == 1:
            return
        with self._failing("barrier"):
            dist.barrier(group=self.pg)

    def broadcast_object(self, obj=None):
        """Rank 0's picklable ``obj`` on every rank."""
        box = [obj]
        with self._failing("broadcast"):
            dist.broadcast_object_list(box, src=self.ranks[0], group=self.pg)
        return box[0]

    def broadcast(self, x: torch.Tensor | None) -> torch.Tensor | None:
        """Rank 0's tensor (or None) on every rank's device (``P()``)."""
        wire = None if self.rank or x is None else self._wire(x)
        meta = self.broadcast_object(
            None if wire is None else (tuple(wire.shape), wire.dtype, x.is_complex()))
        if meta is None:
            return None
        shape, dtype, complex_ = meta
        buf = wire if self.rank == 0 else self._empty(shape, dtype)
        with self._failing("broadcast"):
            dist.broadcast(buf, src=self.ranks[0], group=self.pg)
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
            hosts = [self._wire(p) for p in pieces]
            meta = [(tuple(h.shape), h.dtype, p.is_complex())
                    for h, p in zip(hosts, pieces)]
        meta = self.broadcast_object(meta if self.rank == 0 else None)
        if self.rank == 0:
            self._wait(lambda: self._p2p([(True, h, self.ranks[r], 0)
                                          for r, h in enumerate(hosts) if r]),
                       "scatter")
            return pieces[0].to(self.device)
        shape, dtype, complex_ = meta[self.rank]
        buf = self._empty(shape, dtype)
        self._wait(lambda: self._p2p([(False, buf, self.ranks[0], 0)]), "scatter")
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
        h = self._wire(x)
        if self.rank:
            self._wait(lambda: self._p2p([(True, h, self.ranks[0], 0)]), "gather")
            return None
        bufs = [torch.empty_like(h) for _ in range(self.size - 1)]
        self._wait(lambda: self._p2p([(False, b, self.ranks[r + 1], 0)
                                      for r, b in enumerate(bufs)]), "gather")
        parts = [x] + [_back(b, x, x.is_complex(), self.device) for b in bufs]
        return torch.cat(parts, dim=dim)

    def gather_object(self, obj) -> list | None:
        """Every rank's picklable ``obj`` in rank order on rank 0."""
        out = [None] * self.size if self.rank == 0 else None
        with self._failing("gather"):
            dist.gather_object(obj, out, dst=self.ranks[0], group=self.pg)
        return out


def _init(backend: str, dev: torch.device, **kwargs) -> None:
    """``init_process_group`` on ``backend``; an NCCL rank binds its card
    first (the object collectives use the current device)."""
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, **kwargs)


def init_rank(rank: int, size: int, init_file: str, device) -> TimeGroup:
    """Join the world at ``init_file`` as ``rank`` (on ``world_backend``'s
    choice) -> its TimeGroup."""
    dev = rank_device(rank, device)
    backend = world_backend(size, dev)
    _init(backend, dev, init_method=f"file://{init_file}", rank=rank,
          world_size=size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if rank == 0:
        _say_backend(backend, size)
    return TimeGroup(rank, size, dev)


LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")  # what torchrun sets for each rank


def launched() -> bool:
    """Whether this process is a rank that ``torchrun`` (or anything that
    sets its environment) started."""
    return all(k in os.environ for k in LAUNCH_ENV)


def join_launched_world(device: str | torch.device | None = None
                        ) -> torch.device:
    """Join the world that torchrun's environment describes (on
    ``world_backend``'s choice for the ranks on this host) -> this rank's
    device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU when
    ``device`` names it."""
    dev = rank_device(int(os.environ["LOCAL_RANK"]), device)
    size = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    backend = world_backend(size, dev)
    _init(backend, dev, init_method="env://",
          timeout=datetime.timedelta(seconds=TRAIN_TIMEOUT_S))
    if dist.get_rank() == 0:
        _say_backend(backend, dist.get_world_size())
    return dev


class Mesh:
    """The world laid out as JAX's (data, time) mesh of ``dp`` x ``sp``
    ranks (``make_mesh``): rank d sp + s holds data shard d and time block
    s. ``data`` and ``time`` are this rank's groups along each axis,
    ``world`` the whole world's. Every rank makes every group, in one
    order, as ``dist.new_group`` requires. A 1 x 1 mesh is one process,
    with or without a process group."""

    def __init__(self, dp: int, sp: int, device: torch.device):
        size, rank = ((dist.get_world_size(), dist.get_rank())
                      if dist.is_initialized() else (1, 0))
        if dp * sp != size:
            raise ValueError(f"dp ({dp}) x sp ({sp}) != world size ({size})")
        self.dp, self.sp, self.rank = dp, sp, rank
        self.d, self.s = divmod(rank, sp)
        self.device = torch.device(device)
        rows = [[d * sp + s for s in range(sp)] for d in range(dp)]
        cols = [[d * sp + s for d in range(dp)] for s in range(sp)]
        # a group of one rank needs no process group (its collectives are
        # local), nor does a mesh of one process
        row_pgs = [dist.new_group(r) if len(r) > 1 else None for r in rows]
        col_pgs = [dist.new_group(c) if len(c) > 1 else None for c in cols]
        self.time = TimeGroup(self.s, sp, device, row_pgs[self.d], rows[self.d])
        self.data = TimeGroup(self.d, dp, device, col_pgs[self.s], cols[self.s])
        self.world = TimeGroup(rank, size, device)


def make_mesh(dp: int | None = None, sp: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """A (data, time) mesh over the joined world (or this process alone):
    ``dp`` defaults to the world size over ``sp``; ``device`` this rank's
    device (by default ``rank_device`` of its LOCAL_RANK)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if device is None or torch.device(device).type != "cpu":
        device = rank_device(int(os.environ.get("LOCAL_RANK", 0)), device)
    return Mesh(size // sp if dp is None else dp, sp, device)


def batch_sharding(mesh: Mesh, shape, shard_time: bool = False) -> tuple:
    """The index of this rank's block of an array of ``shape``: rows
    [d B / dp, (d + 1) B / dp), and with ``shard_time`` axis 1's block s of
    sp where the axis exists and sp divides it (a (B, 1) spk_id stays whole
    along time, as JAX's ``shard_batch`` leaves it)."""
    if not shape:
        return ()
    b = shape[0]
    if b % mesh.dp:
        raise ValueError(f"batch {b} not divisible by dp {mesh.dp}")
    n = b // mesh.dp
    index = [slice(mesh.d * n, (mesh.d + 1) * n)]
    if shard_time and len(shape) >= 2 and shape[1] % mesh.sp == 0:
        tb = shape[1] // mesh.sp
        index.append(slice(mesh.s * tb, (mesh.s + 1) * tb))
    return tuple(index)


def shard_batch(mesh: Mesh, batch: dict, shard_time: bool = False) -> dict:
    """This rank's block of every array of a global batch (every rank holds
    the whole batch, drawn from one seed)."""
    return {k: v[batch_sharding(mesh, tuple(v.shape), shard_time)]
            for k, v in batch.items()}


def replicate(mesh: Mesh, module: torch.nn.Module) -> None:
    """Every rank takes rank 0's parameters and buffers, one flattened
    buffer per dtype (JAX's replicated ``P()``)."""
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = mesh.world._wire(torch.cat([t.reshape(-1) for t in group]))
        with mesh.world._failing("replicate"):
            dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, v in zip(group, torch.split(flat, [t.numel() for t in group])):
                t.copy_(v.view_as(t))


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
