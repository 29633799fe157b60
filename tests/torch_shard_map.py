"""``jax.shard_map`` over a ``ddsp_svc_tpu_torch.parallel.mesh`` time
group, for the stream tests (``test_torch_stream_core.py``).

A world's helper ranks import this module to run it, so it imports only
torch: never JAX, nor a test module that does.
"""
import torch


@torch.no_grad()
def shard_map(fn, *arrays, group, in_dim: int = 1, out_dim: int = 1,
              module=None, **kwargs):
    """Rank 0's ``arrays`` cut into equal blocks along ``in_dim``
    (``P(..., axis)``), ``fn(*blocks, group=group, **kwargs)`` on every
    rank (``fn(module, *blocks, ...)`` with a ``module``), its blocks
    joined along ``out_dim`` on rank 0."""
    blocks = [group.scatter_blocks(x, in_dim) for x in arrays]
    out = fn(*([] if module is None else [module]), *blocks, group=group,
             **kwargs)
    return group.gather_blocks(out, out_dim)
