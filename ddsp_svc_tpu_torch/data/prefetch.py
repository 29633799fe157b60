"""Native async batch prefetcher: the ctypes front end of _prefetch.cpp
(mirrors ddsp_svc_tpu/data/prefetch.py).

The reference hides dataset IO latency behind torch
DataLoader(num_workers=2..4) worker processes (data_loaders.py:96-123).
The cached mode (``cache_all_data``) makes that moot, but large corpora do
not fit in RAM; this module is the uncached path's equivalent: a C++
worker pool ``pread``s exactly the crop byte ranges of the .npy/.wav files
into reusable slot buffers while the card is busy with the previous batch,
and the sampler rotates slots double-buffered. The solver takes it for an
uncached corpus without mels, as the JAX solver does.

Batches are bit for bit ``data/dataset.BatchSampler``'s (the same RNG
stream: the crop draw, then one u01 per item that parameterises the
data-dependent gain draw exactly as Generator.uniform does, and the gain
applied in float32 as there), held by tests/test_torch_prefetch.py against
both samplers of both packages.

The library is built with g++ at first use into ``build/prefetch/`` at the
repository root, its file name carrying a hash of the source and flags (as
``ops/kernels.py`` builds the kernels). A failed build, a file that will not
open and an IO error raise: there is no fallback to ``BatchSampler``.
"""
from __future__ import annotations

import ast
import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .dataset import AudioDataset

SOURCE = Path(__file__).resolve().parent / "_prefetch.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "prefetch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
N_SLOTS = 2  # double-buffered: one slot read while the other is drained
N_THREADS = 4  # the worker pool's pread threads
_lib = None
_lib_lock = threading.Lock()


class PfJob(ctypes.Structure):
    _fields_ = [
        ("file_id", ctypes.c_int32),
        ("kind", ctypes.c_int32),
        ("src_off", ctypes.c_int64),
        ("n_src", ctypes.c_int64),
        ("dst_off", ctypes.c_int64),
    ]


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libddsp_prefetch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a matching build exists; -> its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / lib.name
        done = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp_lib), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}\n{done.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent reader never sees half
    return lib


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.pf_create.restype = ctypes.c_void_p
        lib.pf_create.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
        lib.pf_open.restype = ctypes.c_int
        lib.pf_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pf_submit.restype = ctypes.c_int
        lib.pf_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(PfJob), ctypes.c_int
        ]
        lib.pf_wait.restype = ctypes.c_int
        lib.pf_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pf_buffer.restype = ctypes.c_void_p
        lib.pf_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pf_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def npy_index(path: str) -> tuple[int, tuple[int, ...]]:
    """(data byte offset, shape, descr) of a C-order little-endian float
    .npy."""
    with open(path, "rb") as f:
        if f.read(6) != b"\x93NUMPY":
            raise ValueError(f"{path}: not a .npy file")
        major, _minor = f.read(1)[0], f.read(1)[0]
        if major == 1:
            (hlen,) = struct.unpack("<H", f.read(2))
            off = 10 + hlen
        else:
            (hlen,) = struct.unpack("<I", f.read(4))
            off = 12 + hlen
        header = ast.literal_eval(f.read(hlen).decode("latin1"))
    if header["descr"] not in ("<f4", "<f8") or header["fortran_order"]:
        raise ValueError(f"{path}: {header['descr']} fortran_order="
                         f"{header['fortran_order']}, not a C-order float array")
    return off, tuple(header["shape"]), header["descr"]


def wav_index(path: str) -> tuple[int, int, str, int]:
    """(data byte offset, n_samples, kind, sample_rate) of a mono RIFF wav;
    kind in {'pcm16', 'f32'}."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF wav")
        fmt_code, channels, bits, rate = None, None, None, None
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"no data chunk in {path}")
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                fmt_code, channels = struct.unpack("<HH", fmt[:4])
                rate = struct.unpack("<I", fmt[4:8])[0]
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif cid == b"data":
                off = f.tell()
                if channels != 1:
                    raise ValueError(f"{path}: prefetcher needs mono wavs")
                if fmt_code == 1 and bits == 16:
                    return off, size // 2, "pcm16", rate
                if fmt_code == 3 and bits == 32:
                    return off, size // 4, "f32", rate
                raise ValueError(
                    f"{path}: unsupported wav format {fmt_code}/{bits} -- "
                    "use cache_all_data: true for this corpus"
                )
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)


class PrefetchBatchSampler:
    """Double-buffered drop-in for BatchSampler over an uncached
    AudioDataset (load_all_data=False, audio + units streamed from disk)."""

    def __init__(self, dataset: AudioDataset, batch_size: int, seed: int = 0):
        if dataset.with_mel:
            raise NotImplementedError(
                "the prefetcher streams the ddsp-family layout (audio+units);"
                " use cache_all_data: true for diffusion/reflow corpora"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.files = dataset.usable()
        if not self.files:
            raise ValueError(f"no usable files in {dataset.path_root}")
        self.lib = _load_lib()

        d = dataset
        tf = d.crop_frames
        self.tf = tf
        self.n_audio = tf * d.hop_size
        # per-item layout inside a slot: [units (tf, C)] [audio (n_audio)]
        first = self.files[0]
        _, ushape, _ = npy_index(d._feat(first, "units"))
        self.n_unit = ushape[1]
        self.units_bytes = tf * self.n_unit * 4
        self.item_bytes = self.units_bytes + self.n_audio * 4
        slot_bytes = self.item_bytes * batch_size
        self.handle = ctypes.c_void_p(
            self.lib.pf_create(N_SLOTS, slot_bytes, N_THREADS)
        )
        self._slot_views = []
        for s in range(N_SLOTS):
            base = self.lib.pf_buffer(self.handle, s)
            buf = (ctypes.c_float * (slot_bytes // 4)).from_address(base)
            self._slot_views.append(
                np.frombuffer(buf, dtype=np.float32).reshape(
                    batch_size, self.item_bytes // 4
                )
            )

        # file index: data offsets for units npy + audio wav
        self.index = {}
        for name in self.files:
            upath = d._feat(name, "units")
            uoff, ushape_i, descr = npy_index(upath)
            if descr != "<f4" or ushape_i[1] != self.n_unit:
                raise ValueError(f"{upath}: {descr} {ushape_i}, expected <f4 "
                                 f"(n, {self.n_unit})")
            apath = os.path.join(d.path_root, "audio", name)
            aoff, _n, akind, arate = wav_index(apath)
            if arate != d.sample_rate:
                raise ValueError(
                    f"{apath}: wav rate {arate} != config {d.sample_rate} -- "
                    "crop offsets would be silently misaligned"
                )
            self.index[name] = {
                "units_fid": self.lib.pf_open(self.handle, upath.encode()),
                "units_off": uoff,
                "audio_fid": self.lib.pf_open(self.handle, apath.encode()),
                "audio_off": aoff,
                "audio_kind": akind,
            }
            if self.index[name]["units_fid"] < 0 or \
               self.index[name]["audio_fid"] < 0:
                raise OSError(f"prefetcher could not open files for {name}")

        self._plans = [None] * N_SLOTS
        self._inflight = []
        # prime the pipeline: sample() resubmits each slot it drains, so
        # both slots stay in flight
        for s in range(N_SLOTS):
            self._submit(s)
            self._inflight.append(s)

    def _submit(self, slot: int):
        d = self.dataset
        names_idx = self.rng.choice(len(self.files), self.batch_size)
        jobs = (PfJob * (2 * self.batch_size))()
        plan = []
        for i, fi in enumerate(names_idx):
            name = self.files[fi]
            entry = d.buffer[name]
            frame_res = d.hop_size / d.sample_rate
            idx_from = self.rng.uniform(
                0, entry["duration"] - d.waveform_sec - 0.1
            )
            start = int(idx_from / frame_res)
            u01 = self.rng.uniform(0.0, 1.0) if d.use_aug else None
            ix = self.index[name]
            base = i * self.item_bytes
            jobs[2 * i] = PfJob(
                ix["units_fid"], 0,
                ix["units_off"] + start * self.n_unit * 4,
                self.tf * self.n_unit * 4, base,
            )
            if ix["audio_kind"] == "pcm16":
                jobs[2 * i + 1] = PfJob(
                    ix["audio_fid"], 1,
                    ix["audio_off"] + start * d.hop_size * 2,
                    self.n_audio * 2, base + self.units_bytes,
                )
            else:
                jobs[2 * i + 1] = PfJob(
                    ix["audio_fid"], 0,
                    ix["audio_off"] + start * d.hop_size * 4,
                    self.n_audio * 4, base + self.units_bytes,
                )
            plan.append((name, start, u01))
        if self.lib.pf_submit(self.handle, slot, jobs, 2 * self.batch_size) != 0:
            raise RuntimeError(f"prefetch slot {slot} is still in flight")
        self._plans[slot] = plan

    def sample(self) -> dict[str, np.ndarray]:
        d = self.dataset
        slot = self._inflight.pop(0)
        rc = self.lib.pf_wait(self.handle, slot)
        if rc != 0:
            raise OSError("prefetch IO error")
        view = self._slot_views[slot]
        plan = self._plans[slot]
        tf = self.tf
        out = {
            "units": np.empty((self.batch_size, tf, self.n_unit), np.float32),
            "audio": np.empty((self.batch_size, self.n_audio), np.float32),
            "f0": np.empty((self.batch_size, tf, 1), np.float32),
            "volume": np.empty((self.batch_size, tf, 1), np.float32),
            "spk_id": np.empty((self.batch_size, 1), np.int64),
        }
        for i, (name, start, u01) in enumerate(plan):
            entry = d.buffer[name]
            row = view[i]
            units = row[: tf * self.n_unit].reshape(tf, self.n_unit)
            audio = row[tf * self.n_unit : tf * self.n_unit + self.n_audio]
            sl = slice(start, start + tf)
            f0 = entry["f0"][sl]
            vol = entry["volume"][sl]
            audio = audio.copy()
            if u01 is not None:
                max_amp = float(np.max(np.abs(audio))) + 1e-5
                max_shift = min(1.0, np.log10(1.0 / max_amp))
                # == rng.uniform(-1, max_shift) at this stream position; a
                # Python float, as BatchSampler's, so the products round in
                # float32 as there (JAX's prefetcher keeps numpy's float64
                # and differs from its BatchSampler by up to 1 ulp)
                gain = float(10.0 ** (-1.0 + u01 * (max_shift + 1.0)))
                audio = audio * gain
                vol = vol * gain
            out["units"][i] = units
            out["audio"][i] = audio
            out["f0"][i] = f0
            out["volume"][i] = vol
            out["spk_id"][i] = entry["spk_id"]
        # refill the pipeline
        self._submit(slot)
        self._inflight.append(slot)
        return out

    def __iter__(self):
        while True:
            yield self.sample()

    def close(self):
        if getattr(self, "handle", None):
            for s in list(self._inflight):
                self.lib.pf_wait(self.handle, s)
            self.lib.pf_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
