"""Static checks of the port: no module of it (nor chip_smoke.py, nor the
stream tests' ``torch_shard_map.py``, which helper ranks import) imports
JAX, Flax, Optax, the JAX package, PyYAML, msgpack, tqdm or matplotlib --
by an AST scan, since the test interpreter may have imported them already;
the card machine has none of them -- and its entry points default to the
CUDA card."""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ddsp_svc_tpu_torch
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.models.registry import load_model, load_vocoder
from ddsp_svc_tpu_torch.models.vocoder import Enhancer, Vocoder
from ddsp_svc_tpu_torch.utils.device import resolve_device
import torch_helpers  # noqa: F401,E402  (torch's threads under xdist)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddsp_svc_tpu", "yaml", "msgpack",
             "tqdm", "matplotlib")


def _sources():
    files = sorted(Path(ddsp_svc_tpu_torch.__file__).parent.rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_shard_map.py",
                    ROOT / "tests" / "torch_convert_helpers.py"]


def _imports(tree):
    """The module name of every absolute import statement."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imports(tree):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    for entry in (SvcPipeline, SvcPipeline.from_parts, load_model, load_vocoder,
                  Enhancer):
        assert inspect.signature(entry).parameters["device"].default is None, entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: load_model("absent/model_1.ckpt"),
                 lambda: load_vocoder("absent.msgpack"),
                 lambda: Enhancer(vocoder=Vocoder())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()  # resolved before any file is read
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)  # never a silent CPU fallback
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_sources_build_plain():
    """The CUDA sources have a plain C interface (no PyTorch headers, the
    seconds-long nvcc route) and build for sm_90a without fast math, which
    the sinc and sigmoid tolerances need."""
    from ddsp_svc_tpu_torch.ops import kernels

    sources = sorted(kernels.CSRC.glob("*.cu")) + sorted(kernels.CSRC.glob("*.cuh"))
    assert {p.name for p in sources} >= set(kernels.SOURCES)
    for path in sources:
        assert "#include <torch" not in path.read_text(), path
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def test_front_end_entry_points_default_to_cuda(monkeypatch):
    """The units encoder, the encoder builder, the pipeline's constructors
    and the CLI's --device all default to the card, and without one they
    raise before any file is read."""
    from ddsp_svc_tpu_torch.cli import infer as cli_infer
    from ddsp_svc_tpu_torch.cli.common import build_units_encoder
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder

    for entry in (UnitsEncoder, build_units_encoder):
        assert inspect.signature(entry).parameters["device"].default is None, entry
    for entry in (SvcPipeline, SvcPipeline.from_parts):
        params = inspect.signature(entry).parameters
        assert params["device"].default is None and params["device_f0"].default is False
    options = cli_infer.parse_args(["-m", "m.ckpt", "-i", "in.wav", "-o", "out.wav"])
    assert options.device is None
    from ddsp_svc_tpu_torch.cli import batch_infer, export

    assert batch_infer.parse_args(["-m", "m", "-i", "i", "-o", "o"]).device is None
    assert export.parse_args(["-m", "m", "-o", "o"]).device is None
    assert inspect.signature(export.load_exported).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: UnitsEncoder("tiny"),
                 lambda: SvcPipeline("absent/model_1.ckpt"),
                 lambda: batch_infer.main(["-m", "absent/model_1.ckpt", "-i",
                                           "absent", "-o", "out"]),
                 lambda: export.main(["-m", "absent/model_1.ckpt", "-o", "o.pt2"]),
                 lambda: export.load_exported("absent.pt2"),
                 lambda: cli_infer.main(["-m", "absent/model_1.ckpt", "-i",
                                         "absent.wav", "-o", "out.wav"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_infer_needs_the_card_unless_told_cpu(monkeypatch):
    """``SvcPipeline(...).infer`` on a machine without a card: refused with
    "no CUDA device" unless device="cpu" is given, which runs the plain
    versions."""
    import numpy as np

    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
    from ddsp_svc_tpu_torch.models.ddsp import CombSubSuperFast
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.utils.config import DotDict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = DotDict({"data": {"sampling_rate": 16000, "block_size": 64,
                             "encoder_out_channels": 256},
                    "model": {"type": "CombSubSuperFast", "win_length": 256,
                              "n_spk": 1}})
    model = random_init_(CombSubSuperFast(16000, 64, 256, 256, 1),
                         torch.Generator().manual_seed(0))
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(4000) / 16000)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SvcPipeline.from_parts(model, None, args, None).infer(audio, 16000)
    pipe = SvcPipeline.from_parts(model, None, args, None, device="cpu",
                                  units_encoder=UnitsEncoder("tiny", device="cpu"))
    out, sr = pipe.infer(audio, 16000)
    assert sr == 16000 and out.shape == (4000 // 64 * 64 + 64,)
    assert np.isfinite(out).all()


def test_realtime_cli_defaults_to_cuda(monkeypatch):
    """The realtime CLI's --device defaults to the card, and without one it
    raises before any file is read, --voc_bf16 (accepted) included."""
    from ddsp_svc_tpu_torch.cli import realtime as cli_realtime

    argv = ["-m", "absent/model_1.ckpt", "-i", "absent.wav", "-o", "out.wav"]
    assert cli_realtime.parse_args(argv).device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_realtime.main(argv)
    assert cli_realtime.parse_args(argv + ["--voc_bf16"]).voc_bf16
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_realtime.main(argv + ["--voc_bf16"])


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """cli.train, cli.preprocess and cli.train_vocoder: --device defaults to
    the card, and without one each raises "no CUDA device" before any model
    is built."""
    from ddsp_svc_tpu_torch.cli import preprocess as cli_preprocess
    from ddsp_svc_tpu_torch.cli import train as cli_train
    from ddsp_svc_tpu_torch.cli import train_vocoder as cli_train_vocoder
    from ddsp_svc_tpu_torch.utils.config import save_config

    cfg = str(tmp_path / "config.yaml")
    save_config(cfg, {"data": {"sampling_rate": 16000, "block_size": 64},
                      "model": {"type": "CombSubSuperFast"},
                      "train": {"amp_dtype": "fp32"}, "env": {"expdir": "exp"}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (cli_train.main, cli_preprocess.main, cli_train_vocoder.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-c", cfg])


def test_b5_never_falls_back_to_its_plain_version(monkeypatch):
    """B5's wrapper takes its plain version for a CPU tensor only: any other
    tensor goes to the launch, whose checks refuse what is not a CUDA
    tensor, and never to the plain version (here a tensor on the meta
    device, grad on and off)."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer

    def plain(*_):
        raise AssertionError("B5's plain version was called")
    monkeypatch.setattr(cuda_conformer, "conformer_layer_bf16_io_plain", plain)
    x = torch.empty(1, 8, 16, dtype=torch.bfloat16, device="meta")
    w = [torch.empty(s, device="meta") for s in
         ((16, 8), (16,), (64, 16), (64,), (32, 31), (32,), (16, 32), (16,))]
    for grad in (False, True):
        ws = [t.requires_grad_(grad) for t in w]
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_conformer.conformer_layer_bf16_io(
                x, torch.empty(1, 8, 8, device="meta"),
                torch.empty(1, 16, device="meta"), ws,
                packed=tuple(torch.empty(s, dtype=torch.bfloat16, device="meta")
                             for s in ((16, 8), (64, 16), (16, 32))))


def test_f0_nets_default_to_cuda(monkeypatch):
    """The f0 nets, their extractor and the config's builder default to the
    card and raise without one, before the net is built; the host trackers
    need no card."""
    import numpy as np

    from ddsp_svc_tpu_torch.cli.common import build_f0_extractor
    from ddsp_svc_tpu_torch.features import crepe, fcpe, rmvpe
    from ddsp_svc_tpu_torch.features.f0 import F0Extractor

    for entry in (F0Extractor, build_f0_extractor, rmvpe.RMVPE,
                  crepe.CrepeInfer, fcpe.FCPEInfer):
        assert inspect.signature(entry).parameters["device"].default is None, entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("rmvpe", "crepe", "fcpe"):  # refused before the tree is read
        with pytest.raises(RuntimeError, match="no CUDA device"):
            F0Extractor(kind, 16000, 160, model_params={"params": {}})
    for kind in ("dio", "harvest", "praat", "yin"):
        f0 = F0Extractor(kind, 16000, 160).extract(np.zeros(1600, np.float32))
        assert f0.shape == (11,)


def test_k4_bf16_mode_never_falls_back_to_its_plain_version(monkeypatch):
    """K4's wrapper takes its plain version for a CPU tensor only, in both
    modes: bf16 or f32 amplitudes on any other device go to the launch,
    whose checks refuse what is not a CUDA tensor (a meta tensor here,
    grad on and off)."""
    from ddsp_svc_tpu_torch.ops import cuda_oscillator

    def plain(*_):
        raise AssertionError("K4's plain version was called")
    monkeypatch.setattr(cuda_oscillator, "harmonic_bank_plain", plain)
    for dtype in (torch.bfloat16, torch.float32):
        for grad in (False, True):
            amps = torch.empty(1, 4, 8, dtype=dtype, device="meta").requires_grad_(grad)
            with pytest.raises(ValueError, match="CUDA tensor"):
                cuda_oscillator.harmonic_bank(
                    torch.empty(1, 4 * 16, 1, device="meta"), amps, 16)


def test_no_jax_imports_scans_the_parallel_package():
    """The scan above covers every module of ``parallel/`` (which the
    helper ranks run and which must import nothing of JAX)."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for module in ("mesh", "stream", "stream_core", "stream_combsub",
                   "stream_legacy", "stream_vocoder", "stream_cascade"):
        assert f"ddsp_svc_tpu_torch/parallel/{module}.py" in names, module


class _FakeProc:
    def __init__(self, argv, **_):
        self.argv = argv
        _FakeProc.started.append(self)

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def kill(self):
        pass


def test_streamed_ranks_default_to_the_card(monkeypatch, capsys):
    """``World`` (which ``streamed_forward``'s ranks and ``cli.infer
    --stream`` run in) puts rank r on cuda:{r % cards} unless told the CPU,
    says so on stderr when ranks share a card, and without a card refuses
    before it starts a helper; ``convert`` starts its world on the
    pipeline's device, and ``cli.infer --stream`` without --device needs
    the card."""
    from ddsp_svc_tpu_torch.cli import infer as cli_infer
    from ddsp_svc_tpu_torch.ops import kernels
    from ddsp_svc_tpu_torch.parallel import mesh

    assert inspect.signature(mesh.World).parameters["device"].default is None
    assert inspect.signature(mesh.rank_device).parameters["device"].default is None
    _FakeProc.started = []
    monkeypatch.setattr(mesh.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(mesh, "init_rank", lambda rank, size, init, device, *_: (
        mesh.TimeGroup(rank, size, mesh.rank_device(rank, device))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mesh.rank_device(1), lambda: mesh.World(2),
                 lambda: cli_infer.main(["-m", "absent/model_1.ckpt", "-i",
                                         "absent.wav", "-o", "out.wav",
                                         "--stream", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert _FakeProc.started == []
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(kernels, "library", lambda: None)
    assert mesh.rank_device(3) == torch.device("cuda", 0)
    assert mesh.rank_device(1, "cuda") == torch.device("cuda", 0)
    world = mesh.World(2)
    assert world.device == torch.device("cuda", 0)
    argv = _FakeProc.started[-1].argv
    assert argv[argv.index("--device") + 1] == "cuda"
    assert "share 1 CUDA card" in capsys.readouterr().err
    world.close()
    world = mesh.World(2, device="cpu")
    argv = _FakeProc.started[-1].argv
    assert world.device == torch.device("cpu")
    assert argv[argv.index("--device") + 1] == "cpu"
    world.close()

    seen = []

    class Stop(Exception):
        pass

    def fake_world(size, device=None, **_):
        seen.append((size, device))
        raise Stop

    monkeypatch.setattr(mesh, "World", fake_world)
    pipe = type("P", (), {"family": "ddsp", "device": torch.device("cuda")})()
    options = cli_infer.parse_args(["-m", "m", "-i", "i", "-o", "o",
                                    "--stream", "2"])
    with pytest.raises(Stop):
        cli_infer.convert(pipe, None, 16000, options)
    assert seen == [(2, torch.device("cuda"))]


def test_masked_denoiser_chain_never_reaches_a_plain_version(monkeypatch):
    """With an ``edge_mask`` (a streamed block) a NaiveV2Diff layer takes
    JAX's stock chain from its own modules: never K3's wrapper nor its
    plain version (here on meta tensors, which no wrapper takes for the
    CPU). Without the mask a meta tensor goes to K3's launch, which refuses
    what is not a CUDA tensor."""
    from ddsp_svc_tpu_torch.models import naive_v2_diff
    from ddsp_svc_tpu_torch.ops import cuda_conformer

    def refuse(*_, **__):
        raise AssertionError("a conformer kernel wrapper or plain version ran")
    for name in ("conformer_layer_plain", "conformer_layer_bf16_plain",
                 "conformer_layer_bf16_io_plain"):
        monkeypatch.setattr(cuda_conformer, name, refuse)
    net = naive_v2_diff.NaiveV2Diff(mel_channels=8, dim=16, condition_dim=8,
                                    num_layers=2).to("meta")
    spec = torch.empty(1, 12, 8, device="meta")
    step = torch.empty(1, device="meta")
    edge = torch.empty(1, 12, 1, device="meta")
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            net(spec, step, spec)
        for name in ("conformer_layer", "conformer_layer_bf16",
                     "conformer_layer_bf16_io"):
            monkeypatch.setattr(naive_v2_diff, name, refuse)
        out = net(spec, step, spec, edge_mask=edge)
    assert out.shape == (1, 12, 8) and out.device.type == "meta"


def test_a_failed_collective_raises():
    """A helper rank that dies: rank 0's next collective raises (within
    the world's timeout), and closing the world reports the helper's
    failure; nothing falls back to a local answer."""
    from ddsp_svc_tpu_torch.parallel.mesh import World

    world = World(2, device="cpu")
    try:
        world._procs[0].kill()
        world._procs[0].wait()
        with pytest.raises(RuntimeError, match="rank 0/2: all_gather failed"):
            world.group.psum(torch.ones(3))
        with pytest.raises(RuntimeError, match="failed"):
            world.group.exchange(torch.ones(1, 2), None)
    finally:
        world.__exit__(RuntimeError, None, None)
    assert world.group is None


def test_world_splits_the_threads(monkeypatch):
    """A world's ranks split the caller's intra-op threads: each helper
    starts with max(1, threads // size) and rank 0 runs with as many until
    the world closes, then gets its own count back."""
    from ddsp_svc_tpu_torch.parallel import mesh

    _FakeProc.started = []
    monkeypatch.setattr(mesh.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(mesh, "init_rank", lambda rank, size, init, device: (
        mesh.TimeGroup(rank, size, mesh.rank_device(rank, device))))
    before = torch.get_num_threads()
    try:
        for threads, size, each in ((4, 2, 2), (4, 4, 1), (5, 2, 2), (1, 4, 1)):
            torch.set_num_threads(threads)
            _FakeProc.started = []
            with mesh.World(size, device="cpu"):
                assert torch.get_num_threads() == each
                for proc in _FakeProc.started:
                    argv = proc.argv
                    assert argv[argv.index("--threads") + 1] == str(each)
            assert len(_FakeProc.started) == size - 1
            assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(before)


def test_helpers_refuse_code_that_imports_jax():
    """A helper rank resolves a function by its module's name and refuses
    one whose import brings in JAX (a test module's, say); the stream
    tests' ``torch_shard_map`` imports only torch and resolves."""
    probe = ("import sys; from ddsp_svc_tpu_torch.parallel.mesh import _resolve\n"
             "_resolve(sys.argv[1])")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}

    def run(target):
        return subprocess.run([sys.executable, "-c", probe, target], env=env,
                              cwd=ROOT, capture_output=True, text=True)

    ok = run("torch_shard_map:shard_map")
    assert ok.returncode == 0, ok.stderr
    refused = run("torch_helpers:tt")
    assert refused.returncode != 0
    assert "brought in JAX" in refused.stderr


def test_no_jax_imports_scans_the_tools():
    """The scan covers the ONNX export, the GUI and the prefetcher (whose
    C++ source is the port's own copy: the JAX package's is never built)."""
    from ddsp_svc_tpu_torch.data import prefetch

    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for module in ("onnx/__init__", "onnx/shim", "onnx/reader", "onnx/runtime",
                   "onnx/mirrors", "onnx/export", "onnx/validate",
                   "gui/__init__", "gui/i18n", "gui/workflow", "gui/web",
                   "cli/export_onnx", "cli/gui", "data/prefetch"):
        assert f"ddsp_svc_tpu_torch/{module}.py" in names, module
    assert prefetch.SOURCE == ROOT / "ddsp_svc_tpu_torch" / "data" / "_prefetch.cpp"


def test_tool_clis_default_to_cuda(monkeypatch):
    """cli.export_onnx and cli.gui take --device, default the card, and
    without one raise before any file is read or any port is bound."""
    from ddsp_svc_tpu_torch.cli import export_onnx, gui
    from ddsp_svc_tpu_torch.gui.web import GuiApp
    from ddsp_svc_tpu_torch.onnx.export import export_onnx as export
    from ddsp_svc_tpu_torch.onnx.validate import validate_export

    assert export_onnx.build_parser().parse_args(["-m", "m"]).device is None
    assert gui.parse_args([]).device is None
    for entry in (export, validate_export, GuiApp):
        assert inspect.signature(entry).parameters["device"].default is None, entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    served = []
    monkeypatch.setattr("ddsp_svc_tpu_torch.gui.web.serve",
                        lambda *a, **k: served.append(a))
    for call in (lambda: export_onnx.main(["-m", "absent/model_1.ckpt"]),
                 lambda: gui.main(["--port", "0"]),
                 lambda: GuiApp().load_model("absent/model_1.ckpt")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not served


def test_onnx_shim_names_a_missing_exporter_module(monkeypatch):
    """Without the onnx wheel the export patches a private torch module;
    where a torch build lacks it the shim raises and names it (never
    another exporter)."""
    from ddsp_svc_tpu_torch.onnx import shim

    called = []
    monkeypatch.setattr(torch.onnx, "export", lambda *a, **k: called.append(a))
    monkeypatch.setattr(shim, "_onnx_wheel_available", lambda: False)
    monkeypatch.setitem(sys.modules, shim.PROTO_UTILS, None)  # import fails
    with pytest.raises(RuntimeError, match=shim.PROTO_UTILS.replace(".", r"\.")):
        shim.torch_onnx_export(torch.nn.Identity(), (torch.zeros(1),), "x.onnx")
    assert not called
