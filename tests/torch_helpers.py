"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``;
imported as ``torch_helpers``, like ``helpers``).

Inputs, noise and parameters are made with numpy from a seed and handed
to both sides; the JAX side runs jitted on the CPU (eager and jitted JAX
differ by ~1e-4 in places).

Under pytest-xdist each worker gets its share of the machine's cores for
torch's intra-op threads (by default one per core, which spin between
ops): six workers with eight threads each on eight cores spend most of
their time waiting on one another. Every ``test_torch_*.py`` file imports
this module, so the cap holds in every worker that runs one.

The workers run without TensorFlow, as the card machine does: the
trainers' savers write their event files through ``torch.utils.
tensorboard``, which imports TensorFlow where it is installed (some 16 s
a process) and otherwise falls back to TensorBoard's own stub.
"""
import contextlib
import os
import sys

import numpy as np
import torch

import jax

sys.modules.setdefault("tensorflow", None)  # an import of it now fails
_DEFAULT_THREADS = torch.get_num_threads()
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


@contextlib.contextmanager
def default_threads():
    """torch's own intra-op thread count for the block: a parallel
    reduction's order follows the thread count, and a tolerance derived
    with the default holds its sums in that order."""
    capped = torch.get_num_threads()
    torch.set_num_threads(_DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(capped)


def randomize_tree(tree, seed: int):
    """Re-draw every leaf of a flax param tree from numpy (so no projection
    stays at its zero init): kernels U(+-1/sqrt(fan_in)), weight-norm gains
    U(0.5, 1.5), biases U(+-0.1), norm scales 1 + U(+-0.1), embeddings
    N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name in ("kernel", "kernel_v"):
            fan_in = int(np.prod(shape[:-1])) or 1
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        elif name == "kernel_g":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "embedding":
            v = rng.standard_normal(shape) * 0.5
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def tt(x) -> torch.Tensor:
    """numpy / jax array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def rel_err(got, want) -> float:
    """max |got - want| relative to the reference's peak (complex-aware)."""
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def snr_db(want, got) -> float:
    want = np.asarray(want, np.float64)
    err = np.sum((np.asarray(got, np.float64) - want) ** 2)
    return float(10 * np.log10(np.sum(want ** 2) / max(err, 1e-30)))


def f0_contour(t: int, base: float = 220.0, unvoiced=(0.4, 0.55)) -> np.ndarray:
    """(1, T, 1) f0 with vibrato and one unvoiced stretch."""
    f0 = base * 2.0 ** (0.5 / 12 * np.sin(2 * np.pi * np.arange(t) / 7.3))
    f0[int(unvoiced[0] * t):int(unvoiced[1] * t)] = 0.0
    return f0.astype(np.float32)[None, :, None]


def conv_w(kernel) -> torch.Tensor:
    """JAX conv kernel (k, in, out) -> torch (out, in, k)."""
    return tt(np.asarray(kernel).transpose(2, 1, 0))
