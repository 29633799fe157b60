"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources have a plain C interface and no PyTorch headers. At first use
each source is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a``, the objects are linked into one shared library under
``build/kernels/`` at the repository root, and the library is loaded with
``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited source is never served by a stale build. Nothing here
runs at import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("combtooth.cu", "resblock.cu", "conformer.cu", "oscillator.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_RESTYPES = {"ddsp_combtooth_scratch_words": ctypes.c_longlong}
_SIGNATURES = {
    # (f0, carry_offset_q, offset_is_int64, out, phase_frames, scratch,
    #  batch, n_frames, block, sampling_rate, stream)
    "ddsp_combtooth": (_P, _P, _I, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    # (batch, n_frames) -> words of K1's zeroed scratch
    "ddsp_combtooth_scratch_words": (_I, _I),
    # (x, weights[], biases[], kernel_sizes[], dilations[], n_rb, n_dil,
    #  out, t_buf, z_buf, s_buf, batch, length, channels, stream)
    "ddsp_resblock_group": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                            _I, _I, _I, _P),
    # K2's bf16 class: (x, weights[], biases[], kernel_sizes[],
    #  dilations[], n_rb, n_dil, out, acc, z_buf, batch, length, channels,
    #  convs per launch, rows per block, stream)
    "ddsp_resblock_group_bf16": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P),
    # (x, cond, step_vec, wc, bc, w1, b1, wd, bd, w2, b2, out, h, u, s,
    #  batch, t, c, hc, inner, k, stream)
    "ddsp_conformer_layer": (_P,) * 15 + (_I,) * 6 + (_P,),
    # K3's bf16 class: (x, cond, step_vec, wc, bc, w1, b1, wd, bd, w2, b2,
    #  out, h, s, batch, t, c, hc, inner, k, stream); wc, w1, w2, h, s bf16
    "ddsp_conformer_layer_bf16": (_P,) * 14 + (_I,) * 6 + (_P,),
    # B5: (x, cond, cond_bf16, step_vec, wc, bc, w1, b1, wd, bd, w2, b2, out,
    #  h, s, batch, t, c, hc, inner, k, stream); x, out bf16, cond bf16 or f32
    "ddsp_conformer_layer_bf16_io": (_P, _P, _I) + (_P,) * 12 + (_I,) * 6 + (_P,),
    # B3's and B5's branch-free reciprocal against 1 / y: (u64 count, stream)
    "ddsp_rcp_fast_mismatches": (_P, _P),
    # (x, amps, out, batch, n_frames, block, n_harm, stream)
    "ddsp_harmonic_bank": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ddsp_harmonic_bank_bf16amp": (_P, _P, _P, _I, _I, _I, _I, _P),
}


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    log: str        # nvcc's output, including the -Xptxas -v lines


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> BuildInfo:
    """Compile the kernels (once per process; reuses a matching build)."""
    lib = BUILD_DIR / f"libddsp_kernels_{_digest()}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(tmp_lib, lib)  # atomic: a concurrent reader never sees half
    return BuildInfo(lib, time.perf_counter() - t0, "\n".join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with argument types declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call the library's entry point ``entry`` with ``args`` and the
    current stream of ``device``, on ``device``; raise (``check``) on a
    refused launch. The C launchers launch on the current device and raise
    a kernel's shared-memory limit there, so a tensor on another card than
    the current one must have its card made current first. That is done
    only when the two differ: a single-card caller pays one query of the
    current device."""
    fn = getattr(library(), entry)
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, stream_handle(device))
    else:
        err = fn(*args, stream_handle(device))
    check(err, name)


def grad_wanted(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these tensors: grad mode is on and
    one of them requires grad. Serving (``no_grad``, ``inference_mode``)
    never does."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_backward(plain, inputs, needs, grad_out) -> tuple:
    """The backward of a kernel's ``autograd.Function``, as the JAX
    package's custom VJPs take it: autograd through ``plain(*inputs)``,
    recomputed from the saved inputs (no kernel launch). Returns one
    gradient per input, None where ``needs`` is false."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        wanted = [leaf for leaf, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, grad_out,
                                         allow_unused=True) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)


# the namespace of the kernels' registered operators (torch.ops.ddsp_svc.*):
# K1 ``combtooth``, K3 ``conformer_layer``, K4 ``harmonic_bank``
OPS = "ddsp_svc"
_LIBRARY = torch.library.Library(OPS, "DEF")


def register_op(schema: str, plain, launch, fake):
    """Define ``ddsp_svc::<schema>`` with the plain version as its CPU
    implementation, the launch as its CUDA one (which counts the launch,
    so a traced program counts when it runs, never when it is traced) and
    ``fake`` giving the outputs' shapes for tracing and meta tensors.
    Importing the wrapper's module registers it (a fresh process, before
    ``torch.export.load``, too). Returns the operator's overload, which the
    wrappers call while traced (``traced``).

    The low-level ``torch.library.Library`` API, not ``custom_op``: the
    latter wraps each implementation in a guard whose first call imports
    ``torch._dynamo`` (a process's first request took 13.1 s on an H100
    against 1.7 s without it, PERF.md section 6). The operator has no
    autograd kernel: with grad wanted, the wrappers call it inside their
    ``autograd.Function``."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, plain, "CPU")
    _LIBRARY.impl(name, launch, "CUDA")
    torch.library.register_fake(f"{OPS}::{name}", fake, lib=_LIBRARY)
    return getattr(getattr(torch.ops, OPS), name).default


def traced() -> bool:
    """Whether the caller is being traced (``torch.export``, ``torch.compile``):
    the wrappers then call their operator, which the graph keeps as one node.
    Eager calls launch directly (or take the plain version on the CPU):
    routed through the operators, the 10 s diffusion-fast request (61
    calls) read 2.3 ms (4.8 %) slower on an H100, the median of 200 pairs
    of single runs alternated run by run in one process, the operators
    slower in 164 (``scripts/request_walls_ab.py --dispatch``; PERF.md
    section 6), over the 2 % a request may grow."""
    return torch.compiler.is_compiling()


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: serving threads (the
    batchers' workers, the HTTP handlers) may launch at the same time."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check_cuda_input(t: torch.Tensor, name: str, ndim: int,
                     dtype: torch.dtype = torch.float32) -> None:
    """What every kernel takes: a contiguous CUDA tensor of ``dtype``
    (float32 unless the kernel says otherwise)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
