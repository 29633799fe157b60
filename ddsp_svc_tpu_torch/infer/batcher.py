"""Dynamic request batching for serving (mirrors
ddsp_svc_tpu/infer/batcher.py: ``right_sized_slots``, ``deadline_chunks``,
``BatchedSynth``).

Concurrent callers of ``BatchedSynth.infer`` whose requests fall in the same
frame bucket (and carry the same sampler signature) ride one forward: each
request is padded to its bucket (units 0, f0 220 Hz, volume 0), up to
``max_batch`` of them are stacked, and the model runs once at batch n, the
right-sized slot count, so each kernel launches once per batch. Short
batches are filled with dummy rows.

Each row's noise comes from that request's own seeded ``torch.Generator``,
drawn at the bucket length by the forward builder, never from one batch-level
draw: a request's output does not depend on its batch-mates (up to the
numerics of another batch shape, since cuDNN picks its algorithms by batch
size).

On a mesh (``mesh``: a sequence of devices, repeats allowed) a batch's
rows are split into contiguous blocks, rows [d n / D, (d + 1) n / D) on
device d, as JAX's ``P("data")`` splits them: each block runs the batched
forward on its entry's own copy of the parameters, on its device and on a
stream of its own, and the blocks are joined in row order on the first
device before the device-to-host codec. Slots stay right-sized but
divisible by D (``right_sized_slots``), a mesh batch is never split at the
deadline, and its inputs are staged on the host. Each row draws from its
own seeded generator on its block's device, so a sharded batch returns
what the single-device engine returns for the same requests.

The worker thread and the delivery thread each run with autograd off: grad
mode is thread-local, and a thread starts with it on.
"""
from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.codec import i16_decode, i16_encode, mulaw_decode, mulaw_encode_u8
from ..utils.device import resolve_device

DUMMY_SEED = 0  # the dummy rows' noise


def mesh_devices(mesh) -> list[torch.device] | None:
    """A mesh as the engines hold it: one ``torch.device`` per entry, in
    order, repeats kept (a CUDA device without an index is the current
    card). None stays None."""
    if mesh is None:
        return None
    out = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def check_mesh(mesh: list | None, max_batch: int) -> None:
    if mesh is not None and max_batch % len(mesh):
        raise ValueError(f"max_batch {max_batch} not divisible by mesh size "
                         f"{len(mesh)}")


def right_sized_slots(n_real: int, max_batch: int, mesh=None) -> int:
    """Padded row count of a batch: the next power of two >= n_real, capped
    at max_batch; on a mesh of D devices, the smallest power-of-two row
    count per device times D, capped at max_batch. One policy for both
    serving engines."""
    if mesh is not None:
        m = len(mesh)
        per_dev = -(-n_real // m)
        return min(max_batch, m << max(0, (per_dev - 1).bit_length()))
    return min(max_batch, 1 << max(0, (n_real - 1).bit_length()))


class MeshBlocks:
    """The blocks of a mesh: entry d's device and, on a card, a stream of
    its own. ``block(d)`` makes d's device and stream current for the
    block's work, after the work already queued on that device's current
    stream; ``join`` brings the blocks' outputs to the first device in
    entry order, once their streams are done."""

    def __init__(self, devices: list[torch.device]):
        self.devices = devices
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                        for d in devices]

    def rows(self, n: int, d: int) -> slice:
        per = n // len(self.devices)
        return slice(d * per, (d + 1) * per)

    @contextlib.contextmanager
    def block(self, d: int):
        dev, stream = self.devices[d], self.streams[d]
        if stream is None:
            yield dev
            return
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                yield dev

    def join(self, outs: list) -> list:
        """Each block's outputs (a tensor or a tuple of them) on the first
        device, in order."""
        first = self.devices[0]
        joined = []
        for dev, stream, out in zip(self.devices, self.streams, outs):
            single = isinstance(out, torch.Tensor)
            parts = (out,) if single else tuple(out)
            if stream is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_stream(stream)
                for t in parts:  # made on the block's stream, read on this one
                    t.record_stream(current)
                if first.type == "cuda" and first != dev:
                    torch.cuda.current_stream(first).wait_stream(current)
            parts = tuple(t.to(first) for t in parts)
            joined.append(parts[0] if single else parts)
        return joined


def _on(module, device: torch.device) -> bool:
    """Whether ``module``'s parameters lie on ``device`` (true for a module
    without any)."""
    p = (next(iter(module.parameters()), None)
         if isinstance(module, torch.nn.Module) else None)
    return p is None or mesh_devices([p.device])[0] == device


def _replica(module, device: torch.device):
    """A copy of ``module`` on ``device`` (an object that is not a module is
    shared)."""
    if not isinstance(module, torch.nn.Module):
        return module
    return copy.deepcopy(module).to(device)


def deadline_chunks(batch: list, slots_fn) -> list[list]:
    """When the wait deadline leaves a partial batch, dispatch the largest
    power-of-two prefix and a right-sized remainder if that saves at least
    two dummy slots (9 rows: 8 + 1 slots instead of 16)."""
    n = len(batch)
    if n < 3:
        return [batch]
    slots = slots_fn(n)
    big = 1 << (n.bit_length() - 1)  # largest pow2 <= n
    if big == n or slots - n < 2:
        return [batch]
    rest = batch[big:]
    if big + slots_fn(len(rest)) > slots - 2:
        return [batch]
    return [batch[:big], rest]


@dataclass(eq=False)  # identity: _pending.remove() must not compare tensors
class _Request:
    units: object  # (bucket, C) numpy (host staging) or tensor (device)
    f0: object  # (bucket, 1)
    volume: object  # (bucket, 1)
    spk_id: int
    seed: int
    n_frames: int
    bucket: int
    sig: tuple = ()  # static sampler signature; only same-sig requests batch
    on_device: bool = False  # staged as tensors vs numpy (never mixed)
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    error: Exception | None = None

    @property
    def group(self) -> tuple:
        return (self.bucket, self.sig, self.on_device)


def _default_forward(model, bucket: int, block: int):
    """The DDSP synth alone: each row's U(-1, 1) noise drawn at the bucket
    length from its own generator (the draw the model makes itself)."""

    def fwd(units, f0, volume, spk, generators, tframes):
        noise = torch.cat([
            torch.rand((1, bucket * block), generator=g, device=units.device) * 2 - 1
            for g in generators])
        audio, _ = model(units, f0, volume, spk_id=spk, noise=noise)
        return audio

    return fwd


class BatchedSynth:
    """Thread-safe batching front end of a synthesizer on one device, or
    sharded over a mesh of devices.

    ``infer`` blocks the calling thread until its request's batch has run;
    concurrent callers sharing a (bucket, signature) group ride one forward.

    ``forward_builder(bucket, sig) -> fwd(units, f0, volume, spk, generators,
    tframes) -> audio (n, bucket * out_hop)``: ``generators`` holds one
    seeded torch.Generator per row (the dummy rows' too), ``tframes`` (n,)
    each row's real frame count (dummy rows: the bucket), for masking the
    padded tail inside the forward. Without one, the DDSP synth runs alone.
    ``out_hop``: output samples per frame (default ``model.block_size``).

    ``transfer``: the device-to-host codec of the batch output: 'f32',
    'i16' or 'mulaw' (8-bit mu-law). ``transfer_in``: the host-to-device
    codec of units given as host arrays, 'f32' or 'f16'; units and f0 given
    as tensors (the pipeline's encoder output) are padded and stacked on
    the device.
    ``pipeline_depth`` >= 2: a delivery thread waits for batch N's output
    while the worker forms and launches batch N + 1; each output's copy to
    pinned host memory is queued right behind its batch.

    ``mesh``: a sequence of D devices (``max_batch`` divisible by D) over
    which each batch's rows are sharded. ``model`` is then copied to every
    entry but the first on its device, and ``forward_builder``, if given,
    is a sequence of D builders, entry d's building the forward of d's
    block on d's copy of the parameters (``SvcPipeline.enable_batching``
    gives one per replica of itself). ``device`` is ignored: the first
    entry is the engine's device."""

    def __init__(self, model, buckets: tuple[int, ...] = (128, 256, 512, 1024),
                 max_batch: int = 8, max_wait_ms: float = 5.0, mesh=None,
                 forward_builder=None, out_hop: int | None = None,
                 transfer: str = "f32", transfer_in: str = "f32",
                 pipeline_depth: int = 1,
                 device: str | torch.device | None = None):
        self.mesh = mesh_devices(mesh)
        check_mesh(self.mesh, max_batch)
        self.model = model
        if self.mesh is None:
            self.device = resolve_device(device)
            self._blocks = None
        else:
            self.device = self.mesh[0]
            self._blocks = MeshBlocks(self.mesh)
            if forward_builder is not None and (
                    callable(forward_builder)
                    or len(forward_builder) != len(self.mesh)):
                raise ValueError("on a mesh, forward_builder is a sequence of "
                                 f"{len(self.mesh)} builders, one per entry")
            self._models = [model if d == 0 and _on(model, dev) else
                            _replica(model, dev)
                            for d, dev in enumerate(self.mesh)]
        self.buckets = tuple(sorted(buckets))
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.hop = out_hop if out_hop is not None else model.block_size
        self.forward_builder = forward_builder
        if transfer not in ("f32", "i16", "mulaw"):
            raise ValueError(f"unknown transfer codec {transfer!r}")
        self.transfer = transfer
        if transfer_in not in ("f32", "f16"):
            raise ValueError(f"unknown transfer_in codec {transfer_in!r}")
        self.transfer_in = transfer_in
        self._q: queue.Queue = queue.Queue()
        self._pending: list[_Request] = []  # worker-owned
        self._fns: dict = {}
        self._stop = False
        self._stats_lock = threading.Lock()
        self._n_requests = self._n_errors = 0
        self._n_batches = self._n_rows = self._n_slots = 0
        self._latencies_ms: list[float] = []
        self._batch_trace: list[dict] = []
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._deliver_q = None
        self._delivery = None
        if self.pipeline_depth > 1:
            # bounded: the worker blocks rather than queue unbounded outputs
            self._deliver_q = queue.Queue(maxsize=self.pipeline_depth - 1)
            self._delivery = threading.Thread(target=self._delivery_loop,
                                              daemon=True)
            self._delivery.start()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ---- public ---------------------------------------------------------
    def infer(self, units, f0, volume, spk_id: int, seed: int,
              sig: tuple = (), record_stats: bool = True,
              n_frames: int | None = None) -> np.ndarray:
        """units (T, C), f0 and volume (T, 1) -> audio (T * hop,) on the
        host, float32. Blocking. ``seed`` seeds this request's noise.

        units and f0 may be tensors on the device: they are then padded
        there (device staging) and never visit the host. ``n_frames``: the
        real frame count of rows that arrive already padded to the bucket
        (the fused front end pads with this engine's convention)."""
        rows = units.shape[0]
        t = int(n_frames) if n_frames is not None else rows
        bucket = self._bucket_for(t)
        if n_frames is not None and rows > bucket:
            raise ValueError(
                f"pre-padded rows {rows} exceed the bucket {bucket} for "
                f"n_frames={t}: the front end's frame buckets must match the "
                "synthesis buckets")
        # a mesh stages on the host, as JAX's sharded path does
        on_device = (self.mesh is None and isinstance(units, torch.Tensor)
                     and isinstance(f0, torch.Tensor))
        # pad in the submitting thread, so staging runs in parallel across
        # clients instead of in the worker's batch-forming path
        if on_device:
            dev = self.device
            units = F.pad(units.to(dev, torch.float32), (0, 0, 0, bucket - rows))
            f0 = F.pad(f0.to(dev, torch.float32), (0, 0, 0, bucket - rows),
                       value=220.0)
            if isinstance(volume, torch.Tensor):
                volume = F.pad(volume.to(dev, torch.float32),
                               (0, 0, 0, bucket - volume.shape[0]))
            else:  # a host volume rides the worker's stack upload
                volume = self._pad_host(volume, bucket, 0.0, np.float32)
        else:
            in_dtype = np.float16 if self.transfer_in == "f16" else np.float32
            units = self._pad_host(units, bucket, 0.0, in_dtype)
            f0 = self._pad_host(f0, bucket, 220.0, np.float32)
            volume = self._pad_host(volume, bucket, 0.0, np.float32)
        req = _Request(units, f0, volume, int(spk_id), int(seed), t, bucket,
                       sig, on_device=on_device)
        if self._stop:
            raise RuntimeError("BatchedSynth closed")
        t0 = time.monotonic()
        self._q.put(req)
        # stop-aware wait: a put() racing close()'s drain must not hang
        while not req.done.wait(timeout=1.0):
            if self._stop and not req.done.is_set():
                raise RuntimeError("BatchedSynth closed")
        if record_stats:
            with self._stats_lock:
                self._n_requests += 1
                if req.error is not None:
                    self._n_errors += 1
                self._latencies_ms.append((time.monotonic() - t0) * 1000.0)
                if len(self._latencies_ms) > 512:
                    del self._latencies_ms[:-512]
        if req.error is not None:
            raise req.error
        return req.result

    def warmup(self, n_unit: int, sig: tuple = ()) -> None:
        """Run every bucket once from host arrays and once from device
        tensors, then every right-sized slot count once, before
        traffic arrives (the first real request then finds every allocation
        and cuDNN algorithm choice made). Not recorded in ``stats``."""
        for bucket in self.buckets:
            units = np.zeros((bucket, n_unit), np.float32)
            f0 = np.full((bucket, 1), 220.0, np.float32)
            vol = np.zeros((bucket, 1), np.float32)
            self.infer(units, f0, vol, spk_id=1, seed=DUMMY_SEED, sig=sig,
                       record_stats=False)
            self.infer(torch.from_numpy(units).to(self.device),
                       torch.from_numpy(f0).to(self.device), vol, spk_id=1,
                       seed=DUMMY_SEED, sig=sig, record_stats=False)
            sizes = sorted({self._batch_slots(k)
                            for k in range(1, self.max_batch + 1)} - {1})
            with torch.no_grad():
                for n in sizes:
                    self._forward(bucket, sig, np.zeros((n, bucket, n_unit), np.float32),
                                  np.full((n, bucket, 1), 220.0, np.float32),
                                  np.zeros((n, bucket, 1), np.float32),
                                  np.ones((n, 1), np.int64),
                                  np.full((n,), DUMMY_SEED, np.int64),
                                  np.full((n,), bucket, np.int64))
            for dev in dict.fromkeys(self.mesh or [self.device]):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

    def reset_stats(self) -> None:
        """Zero the counters and latency ring (after the warmup drill)."""
        with self._stats_lock:
            self._n_requests = self._n_errors = 0
            self._n_batches = self._n_rows = self._n_slots = 0
            self._latencies_ms.clear()
            self._batch_trace.clear()

    def stats(self) -> dict:
        """Request, error and batch totals, mean occupancy (real rows per
        dispatched slot) and fill (real rows per max_batch), queue depth,
        and latency percentiles over the last 512 requests."""
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            n_req, n_err = self._n_requests, self._n_errors
            n_b, n_rows, n_slots = self._n_batches, self._n_rows, self._n_slots
            trace = list(self._batch_trace[-16:])

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) if lat else None

        return {
            "requests": n_req, "errors": n_err, "batches": n_b,
            "mean_batch_occupancy": (round(n_rows / max(n_slots, 1), 4)
                                     if n_b else None),
            "mean_batch_fill": (round(n_rows / (n_b * self.max_batch), 4)
                                if n_b else None),
            "queue_depth": self._q.qsize() + len(self._pending),
            "latency_ms_p50": pct(0.50), "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
            "buckets": list(self.buckets), "max_batch": self.max_batch,
            "pipeline_depth": self.pipeline_depth,
            "compiled_signatures": len({k[:2] for k in self._fns}),
            "recent_batches": trace,
        }

    def close(self) -> None:
        self._stop = True
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=5)
        if self._delivery is not None:
            # dispatched batches drain first (FIFO before the sentinel); then
            # fail what a dead delivery thread left
            self._deliver_q.put(None)
            self._delivery.join(timeout=30)
            while True:
                try:
                    item = self._deliver_q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    for r in item[1]:
                        r.error = RuntimeError("BatchedSynth closed")
                        r.done.set()
        # no caller may hang on a request the worker will never run
        leftovers = list(self._pending)
        self._pending.clear()
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        for r in leftovers:
            r.error = RuntimeError("BatchedSynth closed")
            r.done.set()

    # ---- internals ------------------------------------------------------
    @staticmethod
    def _pad_host(a, bucket: int, fill: float, dtype) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        a = np.asarray(a, np.float32)
        out = np.full((bucket,) + a.shape[1:], fill, dtype)
        out[:a.shape[0]] = a
        return out

    def _generator(self, seed: int, device=None) -> torch.Generator:
        return torch.Generator(device=device or self.device).manual_seed(int(seed))

    def _bucket_for(self, t: int) -> int:
        for b in self.buckets:
            if t <= b:
                return b
        raise ValueError(
            f"{t} frames exceeds the largest bucket {self.buckets[-1]}; "
            "split the request or add a bucket")

    def _fn(self, bucket: int, sig: tuple = (), entry: int | None = None):
        """The batched forward of a (bucket, signature) group (built once
        per group; on a mesh, once per group and entry)."""
        key = (bucket, sig, entry)
        fn = self._fns.get(key)
        if fn is None:
            if entry is None:
                fwd = (self.forward_builder(bucket, sig) if self.forward_builder
                       else _default_forward(self.model, bucket, self.hop))
            else:
                fwd = (self.forward_builder[entry](bucket, sig)
                       if self.forward_builder
                       else _default_forward(self._models[entry], bucket, self.hop))

            def fn(units, f0, volume, spk, generators, tframes, _fwd=fwd):
                return _fwd(units.float(), f0, volume, spk, generators, tframes)

            self._fns[key] = fn
        return fn

    def _encode(self, audio: torch.Tensor) -> torch.Tensor:
        """The device side of the device-to-host codec."""
        if self.transfer == "i16":
            return i16_encode(audio)
        if self.transfer == "mulaw":
            return mulaw_encode_u8(audio)
        return audio.float()

    def _forward(self, bucket: int, sig: tuple, units, f0, volume, spk, seeds,
                 tframes) -> torch.Tensor:
        """The batch's output on the engine's device, encoded for the host.
        The inputs are host arrays or (single device) tensors on the
        engine's device; ``seeds`` one per row."""
        if self.mesh is None:
            dev = self.device
            out = self._fn(bucket, sig)(
                *(torch.as_tensor(a).to(dev) for a in (units, f0, volume, spk)),
                [self._generator(s) for s in seeds], torch.as_tensor(tframes).to(dev))
            return self._encode(out)
        blocks, outs = self._blocks, []
        for d in range(len(self.mesh)):
            rows = blocks.rows(len(seeds), d)
            with blocks.block(d) as dev:
                outs.append(self._fn(bucket, sig, d)(
                    *(torch.as_tensor(a[rows]).to(dev)
                      for a in (units, f0, volume, spk)),
                    [self._generator(s, dev) for s in seeds[rows]],
                    torch.as_tensor(tframes[rows]).to(dev)))
        return self._encode(torch.cat(blocks.join(outs)))

    def _collect(self) -> list[_Request]:
        """One batch: the oldest waiting request, then same-group requests
        for up to max_wait. Other groups' arrivals wait in ``_pending``,
        which is always served first (age order), so sustained traffic of
        one group cannot starve the others."""
        if self._pending:
            first = self._pending.pop(0)
        else:
            first = self._q.get()
            if first is None:
                return []
        batch = [first]
        for r in list(self._pending):
            if len(batch) >= self.max_batch:
                break
            if r.group == first.group:
                self._pending.remove(r)
                batch.append(r)
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                r = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if r is None:
                self._q.put(None)
                break
            if r.group == first.group:
                batch.append(r)
            else:
                self._pending.append(r)
        return batch

    def _batch_slots(self, n_real: int) -> int:
        return right_sized_slots(n_real, self.max_batch, self.mesh)

    def _chunks(self, batch: list[_Request]) -> list[list[_Request]]:
        """``deadline_chunks`` with this engine's sizing; a mesh batch stays
        whole (its slots are already right-sized and divisible)."""
        if self.mesh is not None:
            return [batch]
        return deadline_chunks(batch, self._batch_slots)

    def _loop(self) -> None:
        with torch.no_grad():  # grad mode is per thread
            while not self._stop:
                batch = self._collect()
                if not batch:
                    continue
                for chunk in self._chunks(batch):
                    try:
                        self._run(chunk, time.monotonic())
                    except Exception as e:  # fail every caller of the chunk
                        for r in chunk:
                            r.error = e
                            r.done.set()

    def _stack(self, batch: list[_Request], n: int, bucket: int):
        """The batch's inputs, dummy rows filled: tensors on the device when
        its requests were staged there, else host arrays; spk, the row
        seeds and each row's real frames on the host."""
        dev = self.device
        c = batch[0].units.shape[1]
        if batch[0].on_device:
            def stack(get, fill, width):
                rows = [get(r) for r in batch]
                rows += [torch.full((bucket, width), fill, device=dev)] * (n - len(rows))
                return torch.stack(rows)

            units = stack(lambda r: r.units, 0.0, c)
            f0 = stack(lambda r: r.f0, 220.0, 1)
            if all(isinstance(r.volume, torch.Tensor) for r in batch):
                volume = stack(lambda r: r.volume, 0.0, 1)
            else:
                volume = np.zeros((n, bucket, 1), np.float32)
                for i, r in enumerate(batch):
                    volume[i] = (r.volume.cpu().numpy()
                                 if isinstance(r.volume, torch.Tensor) else r.volume)
        else:
            in_dtype = np.float16 if self.transfer_in == "f16" else np.float32
            units = np.zeros((n, bucket, c), in_dtype)
            f0 = np.full((n, bucket, 1), 220.0, np.float32)
            volume = np.zeros((n, bucket, 1), np.float32)
            for i, r in enumerate(batch):
                units[i], f0[i], volume[i] = r.units, r.f0, r.volume
        spk = np.ones((n, 1), np.int64)
        tframes = np.full((n,), bucket, np.int64)
        seeds = np.full((n,), DUMMY_SEED, np.int64)
        for i, r in enumerate(batch):
            spk[i, 0], tframes[i], seeds[i] = r.spk_id, r.n_frames, r.seed
        return units, f0, volume, spk, seeds, tframes

    def _run(self, batch: list[_Request], t_formed: float) -> None:
        bucket = batch[0].bucket
        n = self._batch_slots(len(batch))
        inputs = self._stack(batch, n, bucket)
        t_staged = time.monotonic()
        out = self._forward(bucket, batch[0].sig, *inputs)
        # queue the copy to the host right behind the batch
        if out.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(out.device))
        else:
            host, ready = out, None
        trace = {"formed": t_formed, "staged": t_staged,
                 "dispatched": time.monotonic(), "slots": n}
        if self._deliver_q is not None:
            self._deliver_q.put((host, batch, trace, ready))
        else:
            self._finish(host, batch, trace, ready)

    def _finish(self, host, batch: list[_Request], trace: dict, ready) -> None:
        if ready is not None:
            ready.synchronize()
        t_done = time.monotonic()
        out = host.numpy()
        if self.transfer == "i16":
            out = i16_decode(out)
        elif self.transfer == "mulaw":
            out = mulaw_decode(out)
        t_fetched = time.monotonic()
        with self._stats_lock:
            self._n_batches += 1
            self._n_rows += len(batch)
            self._n_slots += trace["slots"]
            # per batch: stage = host work forming the inputs, dispatch =
            # their upload and the forward's launches, device = waiting for
            # the device and the copy, fetch = decoding on the host
            self._batch_trace.append({
                "rows": len(batch), "slots": trace["slots"],
                "stage_ms": round(1e3 * (trace["staged"] - trace["formed"]), 1),
                "dispatch_ms": round(1e3 * (trace["dispatched"] - trace["staged"]), 1),
                "device_ms": round(1e3 * (t_done - trace["dispatched"]), 1),
                "fetch_ms": round(1e3 * (t_fetched - t_done), 1)})
            if len(self._batch_trace) > 64:
                del self._batch_trace[:-64]
        for i, r in enumerate(batch):
            r.result = np.asarray(out[i, :r.n_frames * self.hop], np.float32)
            r.done.set()

    def _delivery_loop(self) -> None:
        with torch.no_grad():
            while True:
                item = self._deliver_q.get()
                if item is None:
                    return
                host, batch, trace, ready = item
                try:
                    self._finish(host, batch, trace, ready)
                except Exception as e:  # a failed fetch fails only its batch
                    for r in batch:
                        r.error = e
                        r.done.set()
