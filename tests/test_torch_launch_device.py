"""Every kernel wrapper launches on its tensor's card (ops/kernels.launch).

The C launchers launch on the current device and raise a kernel's
shared-memory limit there, so a tensor on a card other than the current
one needs its card made current for the call. ``kernels.launch`` does it
only when the two differ. Here, on the CPU, the device calls are stubbed:
the first test holds ``kernels.launch`` to that rule, the second runs each
wrapper's launch function on CPU tensors and checks that it hands
``kernels.launch`` its entry point and its tensor's device."""
import contextlib
import math

import pytest
import torch

import torch_helpers  # noqa: F401  (torch's threads under xdist)
from ddsp_svc_tpu_torch.ops import (cuda_conformer, cuda_oscillator,
                                    cuda_resblock, cuda_source, kernels)


class _Library:
    """Stands for the kernel library: each entry point records the device
    that was current when it was called."""

    def __init__(self, state):
        self.state = state
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, self.state["current"], args))
            return self.state.get("err", 0)
        return entry


@pytest.fixture
def stub_device(monkeypatch):
    """torch.cuda's device calls and the library, stubbed: the current
    device is ``state["current"]``; ``torch.cuda.device(d)`` makes d current
    for its block and is recorded in ``state["entered"]``."""
    state = {"current": 0, "entered": []}

    @contextlib.contextmanager
    def device(d):
        before = state["current"]
        state["entered"].append(torch.device(d).index)
        state["current"] = torch.device(d).index
        try:
            yield
        finally:
            state["current"] = before

    lib = _Library(state)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle",
                        lambda d: 1000 + (d.index if d.index is not None else 99))
    return state, lib


@pytest.mark.parametrize("current,target,switched", [
    (0, "cuda:0", False), (0, "cuda", False), (0, "cuda:1", True),
    (1, "cuda:1", False), (1, "cuda:0", True), (3, "cuda:2", True)])
def test_launch_makes_the_card_current_only_when_it_differs(
        stub_device, current, target, switched):
    state, lib = stub_device
    state["current"] = current
    dev = torch.device(target)
    kernels.launch("k", "ddsp_k", dev, 7, 8)
    name, on, args = lib.calls[-1]
    assert name == "ddsp_k"
    assert state["entered"] == ([dev.index] if switched else [])
    # the launch ran on the tensor's card, with that card's stream last
    assert on == (dev.index if dev.index is not None else current)
    assert args == (7, 8, kernels.stream_handle(dev))
    assert state["current"] == current  # restored after the call


def test_launch_raises_on_a_refused_launch(stub_device):
    state, _ = stub_device
    state["err"] = 1
    with pytest.raises(RuntimeError, match="k: CUDA error 1 at launch"):
        kernels.launch("k", "ddsp_k", torch.device("cuda:1"))
    assert state["current"] == 0


def _conformer_inputs(dtype=torch.float32, cond_dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    b, t, c, hc, inner, k = 2, 8, 16, 8, 16, 3
    x = torch.randn((b, t, c), generator=gen).to(dtype)
    cond = torch.randn((b, t, hc), generator=gen).to(cond_dtype)
    step = torch.randn((b, c), generator=gen)
    w = tuple(torch.randn(shape, generator=gen) for shape in (
        (c, hc), (c,), (2 * inner, c), (2 * inner,), (inner, k), (inner,),
        (c, inner), (c,)))
    return x, cond, step, w


def _resblock_inputs(dtype):
    gen = torch.Generator().manual_seed(1)
    c, ks, ds = 16, (3,), ((1, 3),)
    x = torch.randn((1, 32, c), generator=gen).to(dtype)
    w = [[(torch.randn((c, c, 3), generator=gen) / math.sqrt(3 * c),
           torch.randn((c,), generator=gen)) for _ in range(4)]]
    return x, cuda_resblock.PackedResblocks(w), ks, ds


def _k1():
    f0 = torch.full((2, 5, 1), 220.0)
    return f0, cuda_source._launch, (f0, None, 44100, 512)


def _k2():
    x, packed, ks, ds = _resblock_inputs(torch.float32)
    return x, cuda_resblock._launch, (x, packed, ks, ds)


def _b4():
    x, packed, ks, ds = _resblock_inputs(torch.bfloat16)
    return x, cuda_resblock._launch_bf16, (x, packed, ks, ds)


def _k3():
    x, cond, step, w = _conformer_inputs()
    return x, cuda_conformer._launch, (x, cond, step, w)


def _b3():
    x, cond, step, w = _conformer_inputs()
    return x, cuda_conformer._launch_bf16, (x, cond, step, w,
                                            cuda_conformer.bf16_gemm_weights(w))


def _b5(cond_dtype):
    def make():
        x, cond, step, w = _conformer_inputs(torch.bfloat16, cond_dtype)
        return x, cuda_conformer._launch_bf16_io, (
            x, cond, step, w, cuda_conformer.bf16_gemm_weights(w))
    return make


def _k4(dtype):
    def make():
        x = torch.rand((1, 3 * 16, 1))
        amps = torch.rand((1, 3, 8)).to(dtype)
        return x, cuda_oscillator._launch, (x, amps, 16)
    return make


@pytest.mark.parametrize("make,entry", [
    (_k1, "ddsp_combtooth"), (_k2, "ddsp_resblock_group"),
    (_b4, "ddsp_resblock_group_bf16"), (_k3, "ddsp_conformer_layer"),
    (_b3, "ddsp_conformer_layer_bf16"),
    (_b5(torch.float32), "ddsp_conformer_layer_bf16_io"),
    (_b5(torch.bfloat16), "ddsp_conformer_layer_bf16_io"),
    (_k4(torch.float32), "ddsp_harmonic_bank"),
    (_k4(torch.bfloat16), "ddsp_harmonic_bank_bf16amp")],
    ids=["K1", "K2", "B4", "K3", "B3", "B5-cond-f32", "B5-cond-bf16", "K4",
         "K4-bf16"])
def test_every_wrapper_launches_through_kernels_launch(monkeypatch, make, entry):
    """Each wrapper's launch function hands ``kernels.launch`` its entry
    point and the device of the tensor it was given (here the CPU, with the
    CUDA checks stubbed), and makes no call into the library of its own
    but the host-side query of K1's scratch size."""
    launched = []
    monkeypatch.setattr(kernels, "check_cuda_input", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "count_launch", lambda wrapper: None)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, ent, device, *args: launched.append((ent, device)))
    monkeypatch.setattr(kernels, "library", lambda: _Library({"current": None}))
    monkeypatch.setattr(cuda_resblock, "_sm_count", lambda device: 132)
    tensor, fn, args = make()
    fn(*args)
    assert launched == [(entry, tensor.device)]
