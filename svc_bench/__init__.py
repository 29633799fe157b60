"""The benchmark of the PyTorch and CUDA port (``ddsp_svc_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``registry`` finds a
cell's configuration (``configs/``), traffic mix (``traffic/``), source of
requests (``sources/``), system under test (``systems/``) and per-layer
metric readers (``metrics/``) by name, and ``harness`` drives them;
``reference/`` is the plain float32 PyTorch reference that decides
``correct``. Nothing here imports JAX or the JAX package.
"""
