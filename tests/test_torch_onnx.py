"""The port's ONNX export (``ddsp_svc_tpu_torch/onnx/``,
``cli/export_onnx.py``) against the JAX package's on the same JAX-format
Unit2Mel checkpoint, converted from a synthetic upstream file by the port's
converter (``torch_convert_helpers``) at 2 x 8 channels, k_step_max 10:

  - the port's reader parses both packages' files exactly as JAX's reader
    does: nodes, attributes, initializers, inputs and outputs;
  - for n_spk 1 and 3 the four files of both packages have the same input
    and output names, element types, dynamic axes and opset 16;
  - each port graph under the port's numpy runtime and its JAX counterpart
    under JAX's runtime give the same outputs on the same feeds, at a
    length other than the trace's, within 1e-5 x max|out|;
  - the port's PNDM chain through its files >= 60 dB against the port's
    eager Unit2Mel (the CLI's --check gate), and the port's files passed
    to JAX's own ``validate_export`` >= 60 dB against the JAX model;
  - a non-Diffusion family is refused; the CLI's --check passes and its
    gate fails below 60 dB; JAX's zero-valued-attribute runtime test.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_convert_helpers as up
import torch_helpers  # noqa: F401 (torch's threads under xdist)
from ddsp_svc_tpu.cli.export_onnx import main as jax_main
from ddsp_svc_tpu.onnx import reader as jreader
from ddsp_svc_tpu.onnx import runtime as jruntime
from ddsp_svc_tpu_torch.cli import export_onnx
from ddsp_svc_tpu_torch.convert.__main__ import main as convert_main
from ddsp_svc_tpu_torch.onnx import export_onnx as port_export
from ddsp_svc_tpu_torch.onnx import reader, runtime
from ddsp_svc_tpu_torch.onnx.validate import validate_export
from ddsp_svc_tpu_torch.utils.config import load_config, save_config

N_UNIT, MEL, HID, CHANS, LAYERS, KSTEP = 8, 16, 8, 8, 2, 10
GRAPHS = ("encoder", "denoise", "pred", "after")


def write_checkpoint(d, model: dict, seed: int = 3) -> str:
    """A JAX-format checkpoint and its config.yaml in ``d``, converted from
    a synthetic upstream file -> the checkpoint's path."""
    save_config(d / "config.yaml", {
        "data": {"sampling_rate": 16000, "block_size": 64, "duration": 2,
                 "encoder_out_channels": N_UNIT},
        "model": model})
    args = load_config(str(d / "config.yaml"))
    up.save_upstream(d / "model_3.pt", up.model_state_dict(args, seed=seed), "model")
    convert_main(["model", str(d / "model_3.pt"), str(d / "config.yaml"), str(d)])
    return str(d / "model_3.ckpt")


@pytest.fixture(scope="module", params=[1, 3], ids=["spk1", "spk3"])
def exported(request, tmp_path_factory):
    """(checkpoint, n_spk, the port's four files, JAX's four files)."""
    n_spk = request.param
    d = tmp_path_factory.mktemp(f"onnx{n_spk}")
    ckpt = write_checkpoint(d, {
        "type": "Diffusion", "n_spk": n_spk, "use_pitch_aug": False,
        "n_layers": LAYERS, "n_chans": CHANS, "n_hidden": HID,
        "k_step_max": KSTEP, "out_dims": MEL})
    port = export_onnx.main(["-m", ckpt, "--project", "port", "--n_frames", "12",
                             "--device", "cpu"])
    jax = jax_main(["-m", ckpt, "--project", "jax", "--n_frames", "12"])
    return ckpt, n_spk, port, jax


def _canon(x):
    """A reader's dataclasses as plain comparable values (arrays by dtype,
    shape and bytes)."""
    if dataclasses.is_dataclass(x):
        return tuple(_canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


@pytest.mark.parametrize("graph", GRAPHS)
def test_reader_parses_as_jax(exported, graph):
    _, _, port, jax = exported
    for path in (jax[graph], port[graph]):
        got = reader.load_model_file(path)
        want = jreader.load_model_file(path)
        assert _canon(got) == _canon(want), path
        assert got.graph.nodes and got.opset[""] == 16
        if graph in ("encoder", "denoise"):
            assert got.graph.initializers


def test_files_keep_the_contract(exported):
    """Names, element types, dynamic axes (the dim_param names included)
    and opset of every file equal JAX's; the encoder takes spk_mix only
    with more than one speaker."""
    _, n_spk, port, jax = exported
    assert set(port) == set(GRAPHS)
    for graph in GRAPHS:
        assert port[graph].endswith(f"port_{graph}.onnx")
        got, want = (reader.load_model_file(p[graph]) for p in (port, jax))
        assert got.opset == want.opset and got.opset[""] == 16
        for side in ("inputs", "outputs"):
            assert ([dataclasses.astuple(v) for v in getattr(got.graph, side)]
                    == [dataclasses.astuple(v) for v in getattr(want.graph, side)])
    enc = reader.load_model_file(port["encoder"])
    names = [v.name for v in enc.graph.inputs]
    assert names == ["hubert", "mel2ph", "f0", "volume"] + (["spk_mix"] if n_spk > 1 else [])
    assert isinstance(enc.graph.inputs[0].shape[1], str)  # dynamic time


def _feeds(n_spk: int, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    t, t_units = 20, 15  # the trace ran at 12 frames
    mel2ph = np.concatenate([[0, 0], np.repeat(np.arange(1, t_units + 1), 2)])[:t]
    noise = rng.standard_normal((1, 1, MEL, t)).astype(np.float32)
    enc = {"hubert": rng.standard_normal((1, t_units, N_UNIT)).astype(np.float32),
           "mel2ph": mel2ph[None].astype(np.int64),
           "f0": (rng.random((1, t)) * 300 + 80).astype(np.float32),
           "volume": rng.random((1, t)).astype(np.float32)}
    if n_spk > 1:
        enc["spk_mix"] = rng.random((t, n_spk)).astype(np.float32)
    return {
        "encoder": enc,
        "denoise": {"noise": noise, "time": np.array([7], np.int64),
                    "condition": rng.standard_normal((1, HID, t)).astype(np.float32)},
        "pred": {"noise": noise, "time": np.array([9], np.int64),
                 "noise_pred": rng.standard_normal((1, 1, MEL, t)).astype(np.float32),
                 "time_prev": np.array([4], np.int64)},
        "after": {"x": noise},
    }


@pytest.mark.parametrize("graph", GRAPHS)
def test_graphs_match_jax_under_the_runtime(exported, graph):
    _, n_spk, port, jax = exported
    feeds = _feeds(n_spk)[graph]
    got = runtime.run_model(reader.load_model_file(port[graph]), feeds)
    want = jruntime.run_model(jreader.load_model_file(jax[graph]), feeds)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, name
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, (graph, name)


def test_chain_against_the_port_model(exported):
    ckpt, _, port, _ = exported
    stats = validate_export(ckpt, port, n_frames=16, device="cpu")
    assert stats["steps"] == 5  # speedup max(10 // 10, 2)
    assert stats["snr_db"] >= 60.0, stats


def test_port_files_pass_jax_validate(exported):
    """JAX's own check of the port's artifacts against the JAX model of the
    same checkpoint."""
    from ddsp_svc_tpu.onnx.validate import validate_export as jax_validate

    ckpt, _, port, _ = exported
    stats = jax_validate(ckpt, port, n_frames=16, speedup=2)
    assert stats["steps"] == 5
    assert stats["snr_db"] >= 60.0, stats


def test_refuses_a_non_diffusion_family(tmp_path):
    ckpt = write_checkpoint(tmp_path, {"type": "CombSubSuperFast",
                                       "win_length": 256, "n_spk": 1})
    with pytest.raises(ValueError, match="ddsp_svc_tpu_torch.cli.export"):
        port_export(ckpt, out_dir=str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out").exists()


def test_cli_check(exported, tmp_path, capsys, monkeypatch):
    """--check validates and prints the SNR; below 60 dB it exits."""
    ckpt = exported[0]
    paths = export_onnx.main(["-m", ckpt, "-o", str(tmp_path), "--project", "c",
                              "--n_frames", "10", "--check", "--device", "cpu"])
    assert sorted(paths) == sorted(GRAPHS)
    assert "dB SNR vs checkpoint (5-step PNDM" in capsys.readouterr().out
    import ddsp_svc_tpu_torch.onnx.validate as pv

    monkeypatch.setattr(pv, "validate_export", lambda *a, **k: {
        "snr_db": 59.9, "max_abs": 1.0, "ref_rms": 1.0, "steps": 5})
    with pytest.raises(SystemExit, match="diverges"):
        export_onnx.main(["-m", ckpt, "-o", str(tmp_path), "--project", "d",
                          "--check", "--device", "cpu"])
    with pytest.raises(SystemExit):  # argparse: --check needs every graph
        export_onnx.main(["-m", ckpt, "--graphs", "encoder", "--check",
                          "--device", "cpu"])


def test_runtime_zero_valued_attributes(tmp_path):
    """proto3 omits zero scalars on the wire: Gather axis=0 / Concat axis=0
    must parse as 0, not None (None would make np.take/concatenate
    flatten; JAX's tests/test_onnx_export.py)."""
    from ddsp_svc_tpu_torch.onnx.shim import torch_onnx_export

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("table", torch.randn(7, 5))

        def forward(self, idx, extra):
            rows = self.table.index_select(0, idx)  # Gather axis=0 on 2-D
            return torch.cat([rows, extra], dim=0)  # Concat axis=0

    m = M()
    idx = torch.tensor([3, 0, 6], dtype=torch.long)
    extra = torch.randn(2, 5)
    path = str(tmp_path / "gather0.onnx")
    torch_onnx_export(m, (idx, extra), path, input_names=["idx", "extra"],
                      output_names=["y"], opset_version=16)
    model = reader.load_model_file(path)
    gather = [n for n in model.graph.nodes if n.op_type == "Gather"]
    assert gather and gather[0].attributes.get("axis") == 0  # not None
    got = runtime.run_model(model, {"idx": idx.numpy(), "extra": extra.numpy()})["y"]
    with torch.no_grad():
        ref = m(idx, extra).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)
