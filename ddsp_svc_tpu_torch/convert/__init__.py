"""Upstream DDSP-SVC torch checkpoints -> the port (mirrors
ddsp_svc_tpu/convert/): ``python -m ddsp_svc_tpu_torch.convert``.

Each converter reads an upstream checkpoint with ``torch.load`` on the CPU,
renames its tensors to the port's module names (both are in torch layout,
weight norm kept as (v, g) where the port trains it), and writes the file
the JAX package's converter writes, in the flax msgpack layout, through
the port's own codec (``io/msgpack_codec.py``): the JAX tree comes from the
port's state dict by ``io/jax_params``, so one converted file loads in
both packages. Each also returns the port's state dict in memory. Nothing
here imports JAX, Flax or msgpack.
"""
