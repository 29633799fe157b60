"""Static checks of the port: no module of it (nor chip_smoke.py) imports
JAX, Flax, Optax or the JAX package -- by an AST scan, since the test
interpreter may have imported jax already -- yaml and msgpack only inside
functions, and its entry points default to the CUDA card."""
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

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddsp_svc_tpu")
LAZY_ONLY = ("yaml", "msgpack")


def _sources():
    files = sorted(Path(ddsp_svc_tpu_torch.__file__).parent.rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module name, at module level?) for every import statement."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, at_top in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
        assert not (at_top and root in LAZY_ONLY), (
            f"{path}: imports {name} at module level")


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
