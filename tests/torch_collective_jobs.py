"""A job for ``World.call`` in tests/test_torch_world_backend.py: every
collective of ``TimeGroup`` once. Imports torch and the port only (the
helper ranks import it)."""
import torch


def collectives(x, z, *, group, device_wire: bool = False):
    """Rank 0's real x (B, T, C) and complex z (B, T) scattered in blocks
    along T; the blocks' halos exchanged, summed, gathered, broadcast and
    joined again. ``device_wire`` runs the NCCL path's code (tensors kept
    on the rank's device, the point-to-point ops in one batch) over the
    world's own backend. -> rank 0's results, {name: tensor}."""
    group.nccl = device_wire
    try:
        xb, zb = group.scatter_blocks(x), group.scatter_blocks(z)
        left, right = group.exchange(xb[:, -2:], xb[:, :2])
        zl, zr = group.exchange(zb[:, -1:], zb[:, :1])
        out = {"psum": group.psum(xb), "all_gather": group.all_gather(xb),
               "psum_flat": torch.cat([t.reshape(-1) for t in group.psum_flat(
                   [xb, 2 * xb[:, :3]])]),
               "broadcast": group.broadcast(x if group.rank == 0 else None),
               "broadcast_complex": group.broadcast(z if group.rank == 0 else None),
               "halos": group.gather_blocks(torch.cat([left, xb, right], dim=1)),
               "complex_halos": group.gather_blocks(torch.cat([zl, zb, zr], dim=1)),
               "sum_complex": group.psum(zb)}
        group.barrier()
    finally:
        group.nccl = False
    return out
