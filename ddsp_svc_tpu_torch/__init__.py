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
