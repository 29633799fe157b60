"""The worlds' backend (parallel/mesh.py ``world_backend``): NCCL when each
rank holds a card of its own, gloo when ranks share a card or run on the
CPU; ``init_rank`` and ``join_launched_world`` join on that choice (the
NCCL rank binding its card first) and say it on stderr. The NCCL path's
code (device tensors, batched point-to-point ops) runs here over a
2-rank gloo world on the CPU, every collective bit for bit the host
path's. NCCL itself needs cards; chip_smoke.py phase 26 (c) holds it on
the card against gloo."""
import numpy as np
import pytest
import torch

from ddsp_svc_tpu_torch.parallel import mesh
from ddsp_svc_tpu_torch.parallel.mesh import World, world_backend
from torch_collective_jobs import collectives


@pytest.mark.parametrize("size,device,cards,want", [
    (1, None, 1, "nccl"),     # one rank on the one card
    (2, None, 2, "nccl"),     # a card each
    (2, "cuda", 4, "nccl"),
    (2, None, 1, "gloo"),     # two ranks share the card
    (8, "cuda", 4, "gloo"),
    (1, "cpu", 1, "gloo"),    # CPU worlds
    (4, torch.device("cpu"), 8, "gloo"),
    (1, None, 0, "gloo"),     # no card at all
])
def test_world_backend(monkeypatch, size, device, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert world_backend(size, device) == want


class _Joined(Exception):
    pass


@pytest.mark.parametrize("size,cards,backend", [(2, 2, "nccl"), (2, 1, "gloo")])
def test_init_rank_joins_on_the_chosen_backend(monkeypatch, capsys, size, cards,
                                               backend):
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("set", d))
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, **kw))
    group = mesh.init_rank(0, size, "/nonexistent/rendezvous", None)
    assert seen["backend"] == backend and seen["world_size"] == size
    assert group.device == torch.device("cuda", 0) and not group.nccl
    if backend == "nccl":
        assert seen["set"] == seen["device_id"] == torch.device("cuda", 0)
    else:
        assert "set" not in seen and "device_id" not in seen
    assert f"on {backend}" in capsys.readouterr().err


@pytest.mark.parametrize("local,cards,backend", [("2", 2, "nccl"), ("2", 1, "gloo"),
                                                  ("1", 0, "gloo")])
def test_launched_world_joins_on_the_chosen_backend(monkeypatch, local, cards, backend):
    seen = {}
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("set", d))
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, **kw))
    monkeypatch.setattr(mesh.dist, "get_rank", lambda: 1)
    device = "cpu" if cards == 0 else None
    dev = mesh.join_launched_world(device)
    assert seen["backend"] == backend
    if backend == "nccl":
        assert dev == seen["set"] == seen["device_id"] == torch.device("cuda", 1)


@pytest.fixture(scope="module")
def world():
    with World(2, device="cpu") as w:
        yield w


def test_cpu_world_is_gloo_and_stages_through_the_host(world):
    assert world.group.nccl is False and mesh.dist.get_backend() == "gloo"


def test_device_wire_matches_the_host_path(world):
    """Every collective through the NCCL path's code (over gloo) equals the
    host path's, bit for bit; complex tensors included."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    z = torch.complex(*torch.from_numpy(rng.standard_normal((2, 2, 12))
                                        .astype(np.float32)))
    host = world.call(collectives, x, z)
    wire = world.call(collectives, x, z, device_wire=True)
    assert host.keys() == wire.keys()
    for k in host:
        assert host[k].dtype == wire[k].dtype and torch.equal(host[k], wire[k]), k
    assert torch.equal(host["broadcast"], x)
    assert torch.equal(host["broadcast_complex"], z)
    assert torch.equal(host["psum"], x[:, :6] + x[:, 6:])
    assert torch.equal(host["sum_complex"], z[:, :6] + z[:, 6:])
    # each block's halos: the neighbours' edges, zeros past the ends
    halos = host["halos"].reshape(2, 2, 10, 3)
    assert torch.equal(halos[:, 0, -2:], x[:, 6:8])
    assert torch.equal(halos[:, 1, :2], x[:, 4:6])
    assert not halos[:, 0, :2].any() and not halos[:, 1, -2:].any()
