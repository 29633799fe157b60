"""The streamed drivers' toolkit (``ddsp_svc_tpu_torch/parallel/
stream_core.py``) and the models' sharded reductions on gloo worlds of 2
and 4 CPU ranks, each against the JAX package's counterpart under
``shard_map`` on the forced CPU devices: the frame halo with both edge
fills and the reflect sample halo (exactly), the exact phase-carry prefix
(bit for bit, and the blocked carries equal the whole one), GroupNorm's
masked statistics summed over the group, and FAVOR+ attention's k_sum and
context summed over the group (1e-6 relative to the peak: only the order
of a float sum differs).

Rank 0 is this process; ``torch_shard_map.shard_map`` (which the helper
ranks import, so it imports no JAX) cuts rank 0's arrays into the
blocks ``jax.shard_map``'s in_specs give and joins the blocks its
out_specs join.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ddsp_svc_tpu.models.nn import GroupNorm as JGroupNorm
from ddsp_svc_tpu.models.pcmer import linear_attention as j_linear_attention
from ddsp_svc_tpu.ops.source import frame_phase_increments_q as j_q
from ddsp_svc_tpu.parallel import stream_core as jcore
from ddsp_svc_tpu_torch.models.nn import GroupNorm
from ddsp_svc_tpu_torch.models.pcmer import linear_attention
from ddsp_svc_tpu_torch.ops.source import carry_from_increments_q
from ddsp_svc_tpu_torch.parallel import stream_core
from ddsp_svc_tpu_torch.parallel.mesh import World
from torch_helpers import rel_err, tt
from torch_shard_map import shard_map

WORLD_SIZES = (2, 4)
T = 96  # frames: blocks of 48 or 24


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda n: f"world{n}")
def world(request):
    with World(request.param, device="cpu") as w:
        yield w


def jax_sharded(fn, n, *arrays, in_axis=1, out_axis=1):
    """``fn(*blocks, d, n)`` under jax.shard_map over n CPU devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("time",))

    def spec(axis, ndim):
        return P(*[("time" if i == axis else None) for i in range(ndim)])

    def body(*blocks):
        return fn(*blocks, lax.axis_index("time"), n)

    out = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(spec(in_axis, a.ndim) for a in arrays),
        out_specs=spec(out_axis, arrays[0].ndim), check_vma=False))(
        *map(jnp.asarray, arrays))
    return np.asarray(out)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("edge", [0.0, None], ids=["value", "replicate"])
@pytest.mark.parametrize("h_left,h_right", [(5, 5), (3, 4), (0, 1)])
def test_frame_halo(world, edge, h_left, h_right):
    n = world.size
    x = _x((2, T, 3))
    want = jax_sharded(lambda b, d, n_: jcore._frame_halo(
        b, h_left, h_right, "time", d, n_, edge_value=edge), n, x)
    got = world.call(shard_map, stream_core._frame_halo, tt(x),
                     h_left=h_left, h_right=h_right, edge_value=edge)
    assert got.shape == want.shape == (2, T + n * (h_left + h_right), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_halo_reflect(world):
    n, hs = world.size, 7
    x = _x((2, T * 4))
    want = jax_sharded(lambda b, d, n_: jcore._sample_halo_reflect(
        b, hs, "time", d, n_), n, x)
    got = world.call(shard_map, stream_core._sample_halo_reflect, tt(x), hs=hs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_carry_prefix_bit_for_bit(world):
    """The offsets of haloed blocks (each block's own increments after
    every earlier rank's, less its left halo's) equal JAX's int32 ones
    (int64 here, equal values), and the blocked carries with the bare
    prefix are the whole utterance's carry bit for bit."""
    n, h = world.size, 5
    tb = T // n
    f0 = (200.0 * np.exp(0.3 * np.sin(np.arange(T) / 7.0)))[None, :, None]
    f0 = np.repeat(f0, 2, axis=0).astype(np.float32)
    q = np.array(j_q(jnp.asarray(f0), 16000, 64))  # int32 (2, T, 1)
    # each block's left halo, as the drivers take it (zero before rank 0)
    q_left = np.concatenate([
        np.zeros((2, h, 1), np.int32) if r == 0 else q[:, r * tb - h:r * tb]
        for r in range(n)], axis=1)
    want = jax_sharded(lambda a, b, d, n_: jcore._carry_prefix_offset(
        a, b, "time", d, n_), n, q, q_left)
    got = world.call(shard_map, stream_core._carry_prefix_offset,
                     torch.from_numpy(q), torch.from_numpy(q_left))
    assert got.dtype == torch.int64 and got.shape == (2, n, 1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    prefix = world.call(shard_map, stream_core._carry_prefix_offset,
                        torch.from_numpy(q),
                        torch.zeros((2, n, 1), dtype=torch.int32))
    q_t = torch.from_numpy(q)
    whole = carry_from_increments_q(q_t)
    blocked = torch.cat([
        carry_from_increments_q(q_t[:, r * tb:(r + 1) * tb],
                                prefix[:, r:r + 1])
        for r in range(n)], dim=1)
    assert torch.equal(blocked, whole)


def test_group_norm_masked(world):
    """GroupNorm(4) with a frame mask (a halo's zeros) over the group."""
    n, c = world.size, 16
    x = _x((2, T, c), seed=1) * 3.0 + 1.0
    mask = np.ones((2, T, 1), np.float32)
    mask[:, ::5] = 0.0
    rng = np.random.default_rng(2)
    scale = (1.0 + rng.uniform(-0.1, 0.1, c)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    jgn = JGroupNorm(4)
    params = {"params": {"scale": scale, "bias": bias}}
    want = jax_sharded(lambda a, m, d, n_: jgn.apply(
        params, a, frame_mask=m, axis_name="time"), n, x, mask)
    gn = GroupNorm(4, c)
    with torch.no_grad():
        gn.weight.copy_(tt(scale))
        gn.bias.copy_(tt(bias))
    got = world.call(shard_map, GroupNorm.forward, tt(x), tt(mask), module=gn)
    print(f"GroupNorm over {n} ranks: {rel_err(got, want):.2e}")
    assert rel_err(got, want) <= 1e-6


def test_favor_sums_over_group(world):
    """linear_attention with k_sum and the context summed over the ranks
    (time on axis 2 of (B, H, N, M))."""
    n = world.size
    rng = np.random.default_rng(3)
    q, k = (rng.uniform(0.01, 1.0, (1, 2, T, 12)).astype(np.float32)
            for _ in range(2))
    v = _x((1, 2, T, 8), seed=4)
    want = jax_sharded(lambda a, b, c, d, n_: j_linear_attention(
        a, b, c, stream_axis="time"), n, q, k, v, in_axis=2, out_axis=2)
    got = world.call(shard_map, linear_attention, tt(q), tt(k), tt(v),
                     in_dim=2, out_dim=2)
    print(f"FAVOR+ over {n} ranks: {rel_err(got, want):.2e}")
    assert rel_err(got, want) <= 1e-6
