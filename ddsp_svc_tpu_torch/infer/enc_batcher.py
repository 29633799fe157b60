"""Dynamic request batching for the units encoder (mirrors
ddsp_svc_tpu/infer/enc_batcher.py ``BatchedEncoder``).

Concurrent encode requests whose audio falls in the same bucket (at the
same rate and hop) are zero-padded to the bucket and encoded in one masked
forward (``UnitsEncoder.encode_batched``): each row's valid frames equal a
solo encode of that row. With ``with_f0`` the device YIN of every row runs
in the same batch, and each row's units and f0 come back gathered onto the
synth hop grid and padded to the frame bucket with the synthesis batcher's
convention (units 0, f0 220 Hz), so the submitting thread runs no device
work of its own. A request longer than the largest bucket takes the solo
path. Results stay on the device.

On a mesh (a sequence of devices) a batch's rows are split into contiguous
blocks as ``BatchedSynth`` splits them: each block runs the masked HuBERT
(and the device YIN) on its entry's own copy of the encoder, on its device
and stream, and the blocks' results are joined on the first device in row
order. Each row is the function of its own audio alone, so a sharded batch
returns what the single-device engine returns.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..features.yin_device import make_pipeline_f0_fn
from ..ops.codec import i16_decode, i16_encode, mulaw_decode, mulaw_encode_u8
from .batcher import (MeshBlocks, check_mesh, deadline_chunks, mesh_devices,
                      right_sized_slots)


def encoder_replica(enc, device: torch.device):
    """A copy of the UnitsEncoder ``enc`` on ``device`` (its model's weights
    copied)."""
    rep = copy.copy(enc)
    rep.device = device
    rep.model = copy.deepcopy(enc.model).to(device)
    return rep


@dataclass(eq=False)  # identity: _pending.remove() must not compare tensors
class _EncRequest:
    audio: np.ndarray  # (L,) host audio, in the wire codec
    sample_rate: int
    hop_size: int
    bucket_len: int  # padded sample count (group key)
    index: np.ndarray  # the synth-grid gather index
    want_f0: bool = False  # an encode_with_f0 request (bucket-length rows)
    shift: float = 0.0  # key shift in semitones, applied to the f0
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None  # (1, t, C), or (1, b, C) with want_f0
    result_f0: object = None  # (1, b, 1) with want_f0
    error: Exception | None = None

    @property
    def group(self) -> tuple:
        return (self.bucket_len, self.sample_rate, self.hop_size)


class BatchedEncoder:
    """Thread-safe batching front end of ``UnitsEncoder.encode``.

    ``with_f0``: the device YIN (``features/yin_device``) runs in the same
    batch (``encode_with_f0``). ``transfer_in``: the codec of the batch audio
    on its way to the device, 'f32', 'i16' or 'mulaw' (decoded there).
    ``mesh``: a sequence of D devices (``max_batch`` divisible by D) over
    which each batch's rows are sharded, the encoder copied to every entry
    but the first; results then come back on the first entry's device."""

    def __init__(self, units_encoder, frame_buckets: tuple[int, ...] = (128, 256, 512, 1024),
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 with_f0: bool = False, f0_min: float = 50.0,
                 f0_max: float = 1100.0, transfer_in: str = "f32", mesh=None):
        if transfer_in not in ("f32", "i16", "mulaw"):
            raise ValueError(f"unknown transfer_in codec {transfer_in!r}")
        self.mesh = mesh_devices(mesh)
        check_mesh(self.mesh, max_batch)
        self.enc = units_encoder
        self.device = units_encoder.device
        self._blocks = None
        if self.mesh is not None:
            self.device = self.mesh[0]
            self._blocks = MeshBlocks(self.mesh)
            own = mesh_devices([units_encoder.device])[0]
            self._encs = [units_encoder if d == 0 and dev == own else
                          encoder_replica(units_encoder, dev)
                          for d, dev in enumerate(self.mesh)]
        self.frame_buckets = tuple(sorted(frame_buckets))
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.with_f0 = bool(with_f0)
        self.f0_min, self.f0_max = float(f0_min), float(f0_max)
        self.transfer_in = transfer_in
        self._f0_fns: dict = {}
        self._q: queue.Queue = queue.Queue()
        self._pending: list[_EncRequest] = []
        self._stop = False
        self._stats_lock = threading.Lock()
        self._n_requests = self._n_batches = self._n_rows = self._n_slots = 0
        self._groups: set = set()
        self._batch_trace: list[dict] = []
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ---- public ---------------------------------------------------------
    def encode(self, audio, sample_rate: int, hop_size: int) -> torch.Tensor:
        """audio (L,) -> units (1, L // hop + 1, C) on the device (the
        ``UnitsEncoder.encode`` contract)."""
        audio = self._host(audio)
        bucket = self._bucket(audio.shape[0] // hop_size + 1)
        if bucket is None or self._stop:
            return self.enc.encode(torch.from_numpy(audio)[None], sample_rate,
                                   hop_size)
        idx = self.enc.align_index(audio.shape[0], sample_rate, hop_size)
        req = _EncRequest(self._encode_wire(audio), sample_rate, hop_size,
                          bucket * hop_size, idx)
        return self._submit(req).result

    def encode_with_f0(self, audio, sample_rate: int, hop_size: int,
                       shift: float = 0.0):
        """audio (L,) -> (units (1, b, C), f0 (1, b, 1)) on the device, both
        padded to the frame bucket b beyond the request's L // hop + 1
        frames (units 0, f0 220 Hz), from one batched forward; f0 shifted by
        ``shift`` semitones. A request longer than the largest bucket takes
        the solo path and comes back at its own length."""
        if not self.with_f0:
            raise RuntimeError("BatchedEncoder built without with_f0")
        audio = self._host(audio)
        t = audio.shape[0] // hop_size + 1
        bucket = self._bucket(t)
        if bucket is None or self._stop:
            units = self.enc.encode(torch.from_numpy(audio)[None], sample_rate,
                                    hop_size)
            f0 = self._f0_fn(audio.shape[0], sample_rate, hop_size)(
                torch.from_numpy(audio).to(self.device))
            return units, (f0 * float(2.0 ** (shift / 12.0)))[None, :, None]
        idx = self.enc.align_index(audio.shape[0], sample_rate, hop_size)
        idx = np.pad(idx, (0, bucket - idx.shape[0]), mode="edge")
        req = _EncRequest(self._encode_wire(audio), sample_rate, hop_size,
                          bucket * hop_size, idx, want_f0=True, shift=float(shift))
        req = self._submit(req)
        return req.result, req.result_f0

    def warmup(self, sample_rate: int, hop_size: int) -> None:
        """Run every bucket once at every right-sized slot count before
        traffic arrives."""
        for b in self.frame_buckets:
            self.encode(np.zeros((b - 1) * hop_size, np.float32), sample_rate,
                        hop_size)
            sizes = sorted({self._batch_slots(k) for k in range(1, self.max_batch + 1)})
            for rows in sizes:
                reqs = [_EncRequest(self._encode_wire(np.zeros((b - 1) * hop_size,
                                                               np.float32)),
                                    sample_rate, hop_size, b * hop_size,
                                    np.zeros(b, np.int64), want_f0=self.with_f0)
                        for _ in range(rows)]
                with torch.no_grad():
                    self._run(reqs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._n_requests = self._n_batches = self._n_rows = self._n_slots = 0
            self._batch_trace.clear()

    def stats(self) -> dict:
        with self._stats_lock:
            n_req, n_b = self._n_requests, self._n_batches
            n_rows, n_slots = self._n_rows, self._n_slots
            trace = list(self._batch_trace[-16:])
        return {
            "requests": n_req, "batches": n_b,
            "mean_batch_occupancy": (round(n_rows / max(n_slots, 1), 4)
                                     if n_b else None),
            "mean_batch_fill": (round(n_rows / (n_b * self.max_batch), 4)
                                if n_b else None),
            "compiled_signatures": len(self._groups),
            "recent_batches": trace,
        }

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        self._worker.join(timeout=5)
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
            r.error = RuntimeError("BatchedEncoder closed")
            r.done.set()

    # ---- internals ------------------------------------------------------
    @staticmethod
    def _host(audio) -> np.ndarray:
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().cpu().numpy()
        return np.asarray(audio, np.float32).reshape(-1)

    def _bucket(self, t: int) -> int | None:
        return next((b for b in self.frame_buckets if t <= b), None)

    def _encode_wire(self, audio: np.ndarray) -> np.ndarray:
        """The submit side of the wire codec, in the client's thread."""
        if self.transfer_in == "i16":
            return i16_encode(audio)
        if self.transfer_in == "mulaw":
            return mulaw_encode_u8(audio)
        return audio

    def _submit(self, req: _EncRequest) -> _EncRequest:
        self._q.put(req)
        while not req.done.wait(timeout=1.0):
            if self._stop and not req.done.is_set():
                raise RuntimeError("BatchedEncoder closed")
        with self._stats_lock:
            self._n_requests += 1
        if req.error is not None:
            raise req.error
        return req

    def _f0_fn(self, n_samples: int, sample_rate: int, hop_size: int):
        key = (n_samples, sample_rate, hop_size)
        if key not in self._f0_fns:
            self._f0_fns[key] = make_pipeline_f0_fn(
                n_samples, sample_rate, hop_size, self.f0_min, self.f0_max)
        return self._f0_fns[key]

    def _collect(self) -> list[_EncRequest]:
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

    def _chunks(self, batch: list[_EncRequest]) -> list[list[_EncRequest]]:
        """``deadline_chunks`` with this engine's sizing; a mesh batch stays
        whole."""
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
                        self._run(chunk)
                    except Exception as e:
                        for r in chunk:
                            r.error = e
                            r.done.set()

    def _encode_rows(self, enc, dev, audio: np.ndarray, valid: np.ndarray,
                     sample_rate: int, f0_rows=None):
        """One block's rows on ``dev`` through ``enc``: the wire decoded,
        the masked HuBERT, and with ``f0_rows`` = (index, shift, tframes,
        bucket_len, hop) the device YIN, the gather onto the synth grid and
        the bucket padding -> (units,) or (units, gathered units, f0)."""
        wire = torch.from_numpy(audio).to(dev)
        if audio.dtype == np.int16:
            wire = i16_decode(wire)
        elif audio.dtype == np.uint8:
            wire = mulaw_decode(wire)
        units = enc.encode_batched(wire, sample_rate, torch.from_numpy(valid).to(dev))
        if f0_rows is None:
            return (units,)
        index, shift, tframes, bucket_len, hop = f0_rows
        b_frames = bucket_len // hop
        f0 = self._f0_fn(bucket_len, sample_rate, hop)(wire)[:, :b_frames]
        f0 = f0 * torch.from_numpy(2.0 ** (shift / 12.0)).to(dev)
        ug = torch.gather(units, 1, torch.from_numpy(index).to(dev)[..., None]
                          .expand(-1, -1, units.shape[-1]))
        live = torch.arange(b_frames, device=dev) < torch.from_numpy(tframes).to(dev)
        ug = torch.where(live[..., None], ug, torch.zeros((), device=dev))
        f0 = torch.where(live, f0, torch.full((), 220.0, device=dev))
        return units, ug, f0

    def _run(self, batch: list[_EncRequest]) -> None:
        t_formed = time.monotonic()
        bucket_len, sample_rate, hop = batch[0].group
        n = self._batch_slots(len(batch))
        dtype = {"i16": np.int16, "mulaw": np.uint8}.get(self.transfer_in,
                                                         np.float32)
        fill = 128 if dtype == np.uint8 else 0  # mu-law's zero
        audio = np.full((n, bucket_len), fill, dtype)
        valid = np.full((n,), bucket_len, np.int64)  # dummy rows: full length
        for i, r in enumerate(batch):
            a = r.audio if r.audio.dtype == dtype else self._encode_wire(r.audio)
            audio[i, :a.shape[0]] = a
            valid[i] = a.shape[0]
        f0_rows = None
        if self.with_f0 and any(r.want_f0 for r in batch):
            b_frames = bucket_len // hop
            index = np.zeros((n, b_frames), np.int64)
            shift = np.zeros((n, 1), np.float32)
            tframes = np.full((n, 1), b_frames, np.int64)
            for i, r in enumerate(batch):
                if r.want_f0:
                    index[i], shift[i, 0] = r.index, r.shift
                    tframes[i, 0] = r.audio.shape[0] // hop + 1
            f0_rows = (index, shift, tframes, bucket_len, hop)
        t_staged = time.monotonic()
        if self.mesh is None:
            out = self._encode_rows(self.enc, self.device, audio, valid,
                                    sample_rate, f0_rows)
        else:
            blocks, outs = self._blocks, []
            for d in range(len(self.mesh)):
                rows = blocks.rows(n, d)
                block_f0 = (None if f0_rows is None else
                            (f0_rows[0][rows], f0_rows[1][rows], f0_rows[2][rows],
                             bucket_len, hop))
                with blocks.block(d) as dev:
                    outs.append(self._encode_rows(self._encs[d], dev, audio[rows],
                                                  valid[rows], sample_rate, block_f0))
            out = tuple(torch.cat(parts) for parts in zip(*blocks.join(outs)))
        dev = self.device
        with self._stats_lock:
            self._groups.add(batch[0].group)
            self._n_batches += 1
            self._n_rows += len(batch)
            self._n_slots += n
            self._batch_trace.append({
                "rows": len(batch), "slots": n,
                "stage_ms": round(1e3 * (t_staged - t_formed), 1),
                "dispatch_ms": round(1e3 * (time.monotonic() - t_staged), 1)})
            if len(self._batch_trace) > 64:
                del self._batch_trace[:-64]
        units = out[0]
        for i, r in enumerate(batch):
            if r.want_f0:
                r.result = out[1][i][None]
                r.result_f0 = out[2][i][None, :, None]
            else:
                r.result = units[i][torch.from_numpy(r.index).to(dev)][None]
            r.done.set()
