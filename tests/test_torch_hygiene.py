"""Static checks of the port: no module of it (nor chip_smoke.py) imports
JAX, Flax, Optax, the JAX package, PyYAML, msgpack, tqdm or matplotlib --
by an AST scan, since the test interpreter may have imported them already;
the card machine has none of them -- and its entry points default to the
CUDA card."""
import ast
import inspect
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
    return files + [ROOT / "chip_smoke.py"]


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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: UnitsEncoder("tiny"),
                 lambda: SvcPipeline("absent/model_1.ckpt"),
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
