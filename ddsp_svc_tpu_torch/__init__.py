"""PyTorch / CUDA port of ddsp_svc_tpu for one NVIDIA H100.

The JAX package ``ddsp_svc_tpu`` is the reference: every module here names
the JAX module it mirrors, keeps its feature-last (B, T, C) layout at public
functions, and is held against it by ``tests/test_torch_*.py``. The three
Pallas kernels of the DiffusionFast serving path are hand-written CUDA C++
for sm_90a under ``csrc/``, built at first use (``ops/kernels.py``).

This package imports torch, numpy and scipy only; ``yaml`` and ``msgpack``
are imported inside the functions that read a YAML config or a JAX
checkpoint.
"""
import torch as _torch

# torch's float sqrt, exp, log and kin on the CPU call MKL's vector math
# (VML) in chunks of 2048 elements on the intra-op threads. When a
# process's first VML call is such a parallel one, one thread's chunk now
# and then comes back as x * rsqrtps(x), a 12-bit sqrt, as if MKL's lazy
# set-up raced between the threads (WNLinear's weight norm: 1e-4 of a
# CombSubSuperFast forward's peak; scripts/probe_cpu_repeatability.py).
# One call on this thread first settles it.
_torch.sqrt(_torch.ones(1))
