"""``cli.export`` (``torch.export``) against the port's eager forward and
the JAX package's ``model.apply``, on checkpoints converted from synthetic
upstream files (``torch_convert_helpers``) so that both packages load the
same weights: Sins, CombSubSuperFast, Unit2Mel with ``gt_spec``,
DiffusionFast (with and without its diffusion) and RectifiedFlow.

  - The artifact, saved and loaded (``load_exported``), against the eager
    module with the same draws: within 1e-6 of the peak (the graph runs
    the same ops; measured 0).
  - Against JAX's jitted ``model.apply`` with the same draws through its
    hooks (``noise``, ``ddsp_noise``, ``init_noise``): Sins 2e-4 and
    CombSubSuperFast 2e-3 (tests/test_torch_ddsp_models.py), Unit2Mel 1e-5
    (tests/test_torch_unit2mel.py); the cascades' mels carry the
    combtooth's jitted phase rounding (tests/test_torch_models.py, 2e-3 of
    the synth's peak) through the log-mel and the denoiser: 2e-3 of the
    mel's peak.
  - The graph holds the kernels' registered operators by name
    (``ddsp_svc::combtooth``, ``::conformer_layer``, ``::harmonic_bank``)
    and, for the cascades, the mel extractor's rFFT (the regression of
    tests/test_export.py: a cascade's artifact must take its mel from its
    own DDSP audio, so a new DDSP draw moves the output).
  - A fresh process loads an artifact and reproduces it.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_convert_helpers as up
from ddsp_svc_tpu.utils.config import load_config as jax_load_config
from ddsp_svc_tpu.utils.config import save_config
from ddsp_svc_tpu_torch.cli import export as pexport
from ddsp_svc_tpu_torch.convert.__main__ import main as convert_main
from ddsp_svc_tpu_torch.models.registry import load_model
from torch_helpers import rel_err

ROOT = Path(__file__).resolve().parent.parent
SR, BLOCK, WIN, N_UNIT, T = 16000, 64, 256, 16, 8
SECONDS = str(T * BLOCK / SR)
# family: (model config, -kstep, the ops its graph holds, tolerance vs JAX)
CASES = {
    "Sins": (dict(n_harmonics=8, n_mag_allpass=8, n_mag_noise=8), None,
             {"harmonic_bank"}, 2e-4),
    "CombSubSuperFast": (dict(win_length=WIN), None, {"combtooth"}, 2e-3),
    "Diffusion": (dict(n_layers=2, n_chans=16, n_hidden=16, k_step_max=10), 6,
                  set(), 1e-5),
    "DiffusionFast": (dict(win_length=WIN, n_layers=2, n_chans=16, k_step_max=10),
                      10, {"combtooth", "conformer_layer"}, 2e-3),
    "DiffusionFast-mel": (dict(win_length=WIN, n_layers=2, n_chans=16,
                               k_step_max=10), None, {"combtooth"}, 2e-3),
    "RectifiedFlow": (dict(win_length=WIN, n_layers=2, n_chans=16), None,
                      {"combtooth", "conformer_layer"}, 2e-3),
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per case: (checkpoint path, artifact path, graph text, metadata)."""
    out = {}
    for case, (model_cfg, k_step, _, _) in CASES.items():
        mtype = case.split("-")[0]
        d = tmp_path_factory.mktemp(case)
        save_config(d / "config.yaml", {
            "data": {"sampling_rate": SR, "block_size": BLOCK,
                     "encoder_out_channels": N_UNIT, "duration": 2},
            "model": dict(type=mtype, n_spk=1, **model_cfg)})
        args = jax_load_config(str(d / "config.yaml"))
        up.save_upstream(d / "model_5.pt", up.model_state_dict(args, seed=21), "model")
        convert_main(["model", str(d / "model_5.pt"), str(d / "config.yaml"), str(d)])
        argv = ["-m", str(d / "model_5.ckpt"), "-o", str(d / "model.pt2"),
                "--seconds", SECONDS, "--graph", str(d / "graph.txt"),
                "--device", "cpu"]
        meta = pexport.main(argv + ([] if k_step is None else ["-kstep", str(k_step)]))
        out[case] = (d / "model_5.ckpt", d / "model.pt2",
                     (d / "graph.txt").read_text(), meta)
    return out


def _inputs(meta, seed):
    rng = np.random.default_rng(seed)
    x = {"units": rng.standard_normal((1, T, N_UNIT)).astype(np.float32),
         "f0": np.full((1, T, 1), 220.0, np.float32),
         "volume": np.full((1, T, 1), 0.5, np.float32),
         "spk_id": np.ones((1, 1), np.int32),
         "gt_spec": rng.standard_normal((1, T, 128)).astype(np.float32)}
    draws = pexport.draw(meta, T, torch.Generator().manual_seed(seed), "cpu")
    x.update({k: v.numpy() for k, v in draws.items()})
    return x


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _eager(ckpt, meta, k_step, x):
    model, args = load_model(str(ckpt), device="cpu")
    module, _ = pexport.build_forward(model.eval(), args, k_step)
    with torch.no_grad():
        return module(*(_torch(x)[n] for n in meta["inputs"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_artifact_matches_eager(exported, case):
    ckpt, artifact, _, meta = exported[case]
    x = _inputs(meta, seed=1)
    program = pexport.load_exported(str(artifact), "cpu", seed=0)
    t = _torch(x)
    got = program(t["units"], t["f0"], t["volume"], t["spk_id"], t["gt_spec"],
                  **{n: t[n] for n in meta["draws"]})
    want = _eager(ckpt, meta, CASES[case][1], x)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6
    assert meta["frames"] == T and meta["bytes"] > 0


def _jax_apply(ckpt, case, x):
    from ddsp_svc_tpu.cli.common import build_mel_extractor
    from ddsp_svc_tpu.models.registry import load_model as jax_load_model

    jm, variables, args = jax_load_model(str(ckpt))
    mtype, k_step = args.model.type, CASES[case][1]
    a = {k: jnp.asarray(v) for k, v in x.items()}
    key = jax.random.PRNGKey(0)
    common = dict(spk_id=a["spk_id"], infer=True,
                  rngs={"noise": key, "diffusion": key})
    if mtype in ("Sins", "CombSubSuperFast"):
        fn = lambda v: jm.apply(v, a["units"], a["f0"], a["volume"],  # noqa: E731
                                noise=a["noise"], **common)[0]
    elif mtype == "Diffusion":
        fn = lambda v: jm.apply(v, a["units"], a["f0"], a["volume"],  # noqa: E731
                                gt_spec=a["gt_spec"], k_step=k_step,
                                init_noise=a["init_noise"], **common)
    else:
        mel_x = build_mel_extractor(args)
        kw = {} if mtype == "RectifiedFlow" else {"k_step": k_step}
        fn = lambda v: jm.apply(v, a["units"], a["f0"], a["volume"],  # noqa: E731
                                mel_extract_fn=mel_x.extract,
                                ddsp_noise=a["ddsp_noise"],
                                init_noise=a["init_noise"], **kw, **common)
    return np.asarray(jax.jit(fn)(variables))


@pytest.mark.parametrize("case", sorted(CASES))
def test_artifact_matches_jax(exported, case):
    ckpt, artifact, _, meta = exported[case]
    x = _inputs(meta, seed=2)
    t = _torch(x)
    got = pexport.load_exported(str(artifact), "cpu")(
        t["units"], t["f0"], t["volume"], t["spk_id"], t["gt_spec"],
        **{n: t[n] for n in meta["draws"]})
    want = _jax_apply(ckpt, case, x)
    assert got.shape == want.shape
    assert rel_err(got, want) <= CASES[case][3]


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_holds_the_kernels(exported, case):
    _, _, graph, meta = exported[case]
    ops = {name for name in ("combtooth", "conformer_layer", "harmonic_bank")
           if f"ddsp_svc.{name}.default" in graph}
    assert ops == CASES[case][2]
    if meta["family"] in ("diffusion", "reflow"):
        assert "aten.fft_rfft" in graph  # the mel extractor is in the graph


def test_cascade_mel_comes_from_its_own_audio(exported):
    """Another DDSP draw moves the artifact's output: its mel is the
    synth's, not a stand-in."""
    _, artifact, _, meta = exported["DiffusionFast"]
    x = _torch(_inputs(meta, seed=3))
    program = pexport.load_exported(str(artifact), "cpu")
    args = (x["units"], x["f0"], x["volume"], x["spk_id"])
    a = program(*args, ddsp_noise=x["ddsp_noise"], init_noise=x["init_noise"])
    b = program(*args, ddsp_noise=torch.flip(x["ddsp_noise"], [-1]),
                init_noise=x["init_noise"])
    assert float((a - b).abs().max()) > 1e-3 * float(a.abs().max())
    # the seeded draws: the same seed, the same output
    c = pexport.load_exported(str(artifact), "cpu", seed=4)(*args)
    d = pexport.load_exported(str(artifact), "cpu", seed=4)(*args)
    assert torch.equal(c, d)


def test_fresh_process_loads_the_artifact(exported, tmp_path):
    """The registrations come with ``load_exported``: a new interpreter
    loads the artifact and gives the output of this one, bit for bit (at
    this process's intra-op thread count: a parallel reduction's order
    follows it)."""
    _, artifact, _, meta = exported["RectifiedFlow"]
    x = _inputs(meta, seed=5)
    np.savez(tmp_path / "x.npz", **x)
    t = _torch(x)
    want = pexport.load_exported(str(artifact), "cpu")(
        t["units"], t["f0"], t["volume"], t["spk_id"],
        **{n: t[n] for n in meta["draws"]})
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(int(sys.argv[4]))\n"
        "from ddsp_svc_tpu_torch.cli.export import load_exported\n"
        "x = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[2]).items()}\n"
        "m = load_exported(sys.argv[1], 'cpu')\n"
        "out = m(x['units'], x['f0'], x['volume'], x['spk_id'],\n"
        "        **{n: x[n] for n in m.meta['draws']})\n"
        "np.save(sys.argv[3], out.numpy())\n")
    subprocess.run([sys.executable, "-c", code, str(artifact), str(tmp_path / "x.npz"),
                    str(tmp_path / "out.npy"), str(torch.get_num_threads())],
                   check=True, cwd=ROOT, timeout=300)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def test_export_defaults_to_the_card(monkeypatch):
    import inspect

    assert pexport.parse_args(["-m", "m", "-o", "o"]).device is None
    assert inspect.signature(pexport.load_exported).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexport.load_exported("absent.pt2")


@pytest.mark.parametrize("name", ["conformer_layer", "harmonic_bank"])
def test_traced_wrapper_runs_the_operator_in_its_function(monkeypatch, name):
    """Traced with grad wanted (``torch.compile`` of a training step), K3's
    and K4's wrappers call their operator (which has no autograd kernel)
    inside their ``autograd.Function``: the operator runs, and the
    gradient is the plain version's, bit for bit, as in eager mode."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer, cuda_oscillator, kernels

    rng = np.random.default_rng(7)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).requires_grad_(True)

    if name == "conformer_layer":
        c, hc, inner, k = 8, 4, 16, 5
        inputs = [leaf(1, 6, c), leaf(1, 6, hc), leaf(1, c), leaf(c, hc), leaf(c),
                  leaf(2 * inner, c), leaf(2 * inner), leaf(inner, k), leaf(inner),
                  leaf(c, inner), leaf(c)]
        wrapper = lambda *a: cuda_conformer.conformer_layer(*a[:3], tuple(a[3:]))
        plain = lambda *a: cuda_conformer.conformer_layer_plain(*a[:3], tuple(a[3:]))
        function = "ConformerLayerFunction"
    else:
        inputs = [leaf(1, 4 * 16, 1), leaf(1, 4, 8)]
        wrapper = lambda *a: cuda_oscillator.harmonic_bank(*a, 16)
        plain = lambda *a: cuda_oscillator.harmonic_bank_plain(*a, 16)
        function = "HarmonicBankFunction"
    grad_out = torch.from_numpy(rng.standard_normal(
        tuple(plain(*inputs).shape)).astype(np.float32))
    want = torch.autograd.grad(plain(*inputs), inputs, grad_out)
    module = cuda_conformer if name == "conformer_layer" else cuda_oscillator
    handle = f"_{name.upper()}"
    op, calls = getattr(module, handle), []
    monkeypatch.setattr(module, handle, lambda *a: calls.append(1) or op(*a))
    monkeypatch.setattr(kernels, "traced", lambda: True)
    out = wrapper(*inputs)
    assert calls == [1] and function in out.grad_fn.name()
    got = torch.autograd.grad(out, inputs, grad_out)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
