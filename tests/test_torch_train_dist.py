"""Multi-process training in the port, on CPU ranks: the data-parallel
steps (``train/steps.py``, ``train/vocoder_solver.py`` with a mesh),
``cli.train`` under a torchrun launch, and the sequence-parallel cascade
step (``parallel/train_sp.py``) against JAX's
(``ddsp_svc_tpu/parallel/train_sp.py``).

Each world is launched once per module (``parallel/launch.py``, torchrun's
environment, the wall bounded at WALL s: a hang kills the ranks and fails
in under that) and runs every job of the module's spec
(``torch_dist_jobs.py``); the one-process references run here.

Tolerances:
  - Ranks: bit for bit (parameters, buffers, AdamW's moments, the summed
    gradients), as every rank sums the gradients in one order and applies
    the same update.
  - N ranks against one process (on one thread, as each rank): each
    rank's share of the mean adds in another order, a few f32 ulps of the
    loss (LOSS_TOL 2e-6 relative, every step) and of the first step's
    gradients (DP_GRAD_TOL 1e-5 x max|leaf|; the first conv's, an
    ill-conditioned sum, at ~1e-6). AdamW's first update turns an element
    whose gradient is within that of 0, and moves the others by what it
    allows through the update's derivative (``_first_update_close``); the
    second step starts from those parameters, so after it the parameters
    are held within AdamW's reach, lr per step each way.
  - ``cli.train``, 2 ranks against 1: the parameters within 2 lr x steps,
    AdamW's moments at MOMENT_TOL 1e-4 x max|leaf|.
  - The sequence-parallel step against JAX (its (1, 2) and (2, 2) meshes of
    the conftest's CPU devices; the draws built as JAX draws them per frame
    and per data shard, injected): the loss terms at SP_LOSS_TOL 1e-5
    relative, every gradient leaf at SP_GRAD_TOL 3e-4 x max|leaf| (JAX's
    step is jitted: XLA reorders the sums of the streamed synth and of the
    log-mel, whose gradient weights each bin by 1 / mel; measured 1.06e-4
    on the first conv at (2, 2)), and the parameters after AdamW's first
    update by ``_first_update_close``. The port's (1, 2) and (2, 2)
    against its (1, 1): the loss terms at LOSS_TOL, the gradients at
    SP_INV_GRAD_TOL 1e-5 x max|leaf|.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from ddsp_svc_tpu.models.registry import build_model as jax_build_model
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JMel
from ddsp_svc_tpu.parallel.train_sp import make_sp_cascade_train_step
from ddsp_svc_tpu.train.state import TrainState as JTrainState
from ddsp_svc_tpu_torch.cli import train as ptrain
from ddsp_svc_tpu_torch.cli import train_vocoder as pvoc
from ddsp_svc_tpu_torch.io.jax_params import (load_state, model_state_dict,
                                              moments_params)
from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.ops.mel import LogMelSpectrogram
from ddsp_svc_tpu_torch.parallel import launch
from ddsp_svc_tpu_torch.parallel import mesh as mesh_lib
from ddsp_svc_tpu_torch.utils.config import DotDict, save_config
from torch_dist_jobs import run_job
from torch_helpers import randomize_tree
from torch_train_helpers import batch as train_batch
from torch_train_helpers import leaves, tiny_config

ROOT = Path(__file__).resolve().parent.parent
JOBS = str(Path(__file__).resolve().parent / "torch_dist_jobs.py")
WALL = 240.0
LR = 1e-3
LOSS_TOL, DP_GRAD_TOL, MOMENT_TOL = 2e-6, 1e-5, 1e-4
SP_LOSS_TOL, SP_GRAD_TOL, SP_INV_GRAD_TOL = 1e-5, 3e-4, 1e-5
CFG = dict(sampling_rate=16000, num_mels=16, n_fft=64, win_size=64, hop_size=4,
           fmin=0, fmax=8000, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=32, resblock="1",
           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
PERIODS, MSD = (2, 3), 2
# the sequence-parallel shapes of tests/test_train_sp.py
SR, HOP, WIN, N_UNIT, M, B, T = 16000, 64, 256, 16, 16, 4, 192


def _world(tmp, name, jobs, nproc):
    out = tmp / name
    out.mkdir()
    torch.save(jobs, out / "spec.pt")
    launch.launch([JOBS, str(out / "spec.pt"), str(out)], nproc, WALL, cwd=str(ROOT))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(nproc)]


# ---- data parallel ---------------------------------------------------------

def _dp_job(mtype):
    args = tiny_config(mtype)
    model = random_init_(build_model(args), torch.Generator().manual_seed(1))
    x = [train_batch(mtype, b=4, seed=s) for s in (2, 3)]
    if mtype == "Sins":
        for xi in x:
            xi.pop("mel", None)
        rng = np.random.default_rng(4)
        draws = {"noise": rng.uniform(-1, 1, x[0]["audio"].shape).astype(np.float32),
                 "rss_idx": np.array([0, 5, 9, 15])}
        return dict(kind="dp", family="ddsp", model=model, lr=LR, seed=7,
                    steps=[(x[0], draws), (x[1], None)])
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor

    rng = np.random.default_rng(4)
    t = x[0]["units"].shape[1]
    draws = {"ddsp_noise": rng.standard_normal((4, t * 512)).astype(np.float32),
             "t": np.array([3, 50, 97, 12]),
             "noise": rng.standard_normal((4, t, 128)).astype(np.float32)}
    return dict(kind="dp", family="diffusion", model=model, lr=LR, seed=7,
                k_step_max=100, mel=build_mel_extractor(args),
                steps=[(x[0], draws), (x[1], None)])


def _gan_job():
    """test_torch_vocoder_train.py's small GAN at batch 4."""
    from ddsp_svc_tpu_torch.train.vocoder_solver import Discriminators

    gen = random_init_(pvoc.build_generator(CFG), torch.Generator().manual_seed(1))
    discs = random_init_(Discriminators(PERIODS, MSD),
                         torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    steps = []
    for i in range(2):
        f0 = (150 + 50 * rng.random((4, 75, 1))).astype(np.float32)
        f0[:, :5] = 0.0
        x = {"mel": (rng.standard_normal((4, 75, 16)) - 3).astype(np.float32),
             "f0": f0, "audio": (0.3 * rng.standard_normal((4, 300))).astype(np.float32)}
        sine = None
        if i == 0:  # injected in the first iteration, drawn in the second
            sine = {"rand_ini": rng.random((1, 1, 9)).astype(np.float32),
                    "noise": rng.standard_normal((4, 300, 9)).astype(np.float32)}
            sine["rand_ini"][..., 0] = 0.0
        steps.append((x, sine, sine))
    return dict(kind="gan", generator=gen, discriminators=discs, lr=2e-4, seed=5,
                mel=pvoc.build_mel(CFG), steps=steps)


# ---- sequence parallel: JAX's step and its draws ---------------------------

def _sp_args(family):
    return DotDict({
        "data": {"sampling_rate": SR, "block_size": HOP, "encoder_out_channels": N_UNIT},
        "model": {"type": "DiffusionFast" if family == "diffusion" else "RectifiedFlow",
                  "n_spk": 2, "win_length": WIN, "n_layers": 2, "n_chans": 32,
                  "k_step_max": 100, "use_pitch_aug": False}})


def _sp_batch():
    rng = np.random.default_rng(7)
    return {"units": rng.standard_normal((B, T, N_UNIT)).astype(np.float32),
            "f0": (200.0 * np.exp(0.3 * np.sin(np.arange(T) / 9.0))[None, :, None]
                   * np.ones((B, 1, 1))).astype(np.float32),
            "volume": 0.5 * np.ones((B, T, 1), np.float32),
            "mel": (-6.0 + 2.0 * rng.standard_normal((B, T, M))).astype(np.float32),
            "spk_id": np.ones((B, 1), np.int32)}


def _jax_sp_draws(key, dp, family, k_step_max=100, t_start=0.0):
    """JAX's draws of its step (train_sp.py:104-121, 209-212) at the global
    shapes: frame k of data shard d draws from its frame key folded with
    d, the row draws from the step key folded with d."""
    key_step, key_ddsp, key_noise = jax.random.split(key, 3)
    dkeys, nkeys = jax.random.split(key_ddsp, T), jax.random.split(key_noise, T)
    b_l = B // dp
    ddsp, noise, t = [], [], []
    for d in range(dp):
        blocks = jax.vmap(lambda k: jax.random.normal(
            jax.random.fold_in(k, d), (b_l, HOP), jnp.float32))(dkeys)
        ddsp.append(blocks.transpose(1, 0, 2).reshape(b_l, T * HOP))
        noise.append(jax.vmap(lambda k: jax.random.normal(
            jax.random.fold_in(k, d), (b_l, M), jnp.float32))(nkeys).transpose(1, 0, 2))
        row_key = jax.random.fold_in(key_step, d)
        if family == "diffusion":
            t.append(jax.random.randint(row_key, (b_l,), 0, k_step_max))
        else:
            u = jax.random.uniform(row_key, (b_l,), jnp.float32)
            t.append(jnp.clip(t_start + (1.0 - t_start) * u, 1e-7, 1 - 1e-7))
    cat = lambda xs: np.asarray(jnp.concatenate(xs))  # noqa: E731
    return {"ddsp_noise": cat(ddsp), "t": cat(t),
            ("noise" if family == "diffusion" else "x_0"): cat(noise)}


def _sp_case(family, dp, sp, seed):
    """JAX's model with params drawn from its init's shapes, and the port's
    job with the same params and JAX's draws -> (JAX's step and its
    inputs, the params' leaves, the job)."""
    args = _sp_args(family)
    jmodel = jax_build_model(args, vocoder_dimension=M)
    jmel = JMel(sr=SR, n_mels=M, n_fft=256, win_size=256, hop_length=HOP,
                fmin=40.0, fmax=7000.0)
    x = _sp_batch()
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    kw = dict(infer=False, gt_spec=xj["mel"], mel_extract_fn=jmel.extract,
              key=jax.random.PRNGKey(3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)},
        xj["units"], xj["f0"], xj["volume"], spk_id=xj["spk_id"], **kw))
    params = randomize_tree(shapes["params"], seed)
    key = jax.random.PRNGKey(11)
    port = build_model(args, vocoder_dimension=M)
    load_state(port, model_state_dict(args.model, params))
    job = dict(kind="sp", family=family, model=port, lr=LR, dp=dp, sp=sp,
               k_step_max=100 if family == "diffusion" else None,
               mel=LogMelSpectrogram(sr=SR, n_mels=M, n_fft=256, win_size=256,
                                     hop_length=HOP, fmin=40.0, fmax=7000.0),
               steps=[(x, _jax_sp_draws(key, dp, family))])
    return (jmodel, jmel, params, xj, key), job


def _jax_sp(jmodel, jmel, params, xj, key, family, dp, sp):
    """JAX's step on a (dp, sp) mesh with SGD(1) -> (the params' leaves,
    its metrics, its gradient leaves)."""
    tx = optax.sgd(1.0)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                        opt_state=tx.init(params), apply_fn=jmodel.apply, tx=tx)
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp), ("data", "time"))
    step = make_sp_cascade_train_step(
        jmodel, jmel, mesh, family=family,
        k_step_max=100 if family == "diffusion" else None)
    new, metrics = step(state, xj, key)
    grads = leaves(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, new.params))
    return (leaves(jax.tree_util.tree_map(np.asarray, params)),
            {k: float(v) for k, v in metrics.items()}, grads)


# ---- the worlds ------------------------------------------------------------

SP_CASES = (("diffusion", 1, 2, 5), ("reflow", 1, 2, 6), ("diffusion", 2, 2, 5))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' rank results (a 2-rank world running every 2-rank job,
    a 4-rank one the (2, 2) step) and JAX's sequence-parallel steps. One at
    a time: the worlds' processes share the machine with the other test
    workers."""
    cases = {c[:3]: _sp_case(*c) for c in SP_CASES}
    jobs2 = {"collectives": dict(kind="collectives", n=6, seed=3, sp=2),
             "DiffusionFast": _dp_job("DiffusionFast"), "Sins": _dp_job("Sins"),
             "gan": _gan_job(), "sp-diffusion": cases["diffusion", 1, 2][1],
             "sp-reflow": cases["reflow", 1, 2][1]}
    tmp = tmp_path_factory.mktemp("dist")
    world2 = _world(tmp, "world2", list(jobs2.values()), 2)
    world4 = _world(tmp, "world4", [cases["diffusion", 2, 2][1]], 4)
    return {"jobs2": jobs2, "world2": {n: [r[i] for r in world2]
                                       for i, n in enumerate(jobs2)},
            "job4": cases["diffusion", 2, 2][1], "world4": [r[0] for r in world4],
            "jax": {k: _jax_sp(*case, *k) for k, (case, _) in cases.items()}}


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds["jobs2"], worlds["world2"]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds["job4"], worlds["world4"]


@pytest.fixture(scope="module")
def jax_sp(worlds):
    return worlds["jax"]


def _one_process(job):
    """The job in this process, on one thread as each rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_job(job, None)
    finally:
        torch.set_num_threads(threads)


def _bit_identical(ranks):
    for steps in zip(*ranks):
        for part in ("params", "mu", "nu", "grads"):
            for r in steps[1:]:
                assert r[part].keys() == steps[0][part].keys()
                for k, v in steps[0][part].items():
                    assert torch.equal(r[part][k], v), (part, k)


def _first_update_close(after: dict, grads: dict, want: dict,
                        lr: float, grad_tol: float):
    """A parameter after AdamW's first update, p - lr g / (|g| + eps) (and
    the same decay), against ``want``, when the gradients may differ by
    delta = grad_tol x max|g| of the leaf: where |g| <= delta the step may
    turn, 2 lr; elsewhere what delta moves it through the update's
    derivative in g, lr eps / (|g| + eps)^2, at its steepest within delta;
    and 1e-6 x max|p| for the update's own rounding."""
    for k, g in grads.items():
        g = np.abs(np.asarray(g, np.float64))
        delta = grad_tol * g.max()
        allowed = np.where(g <= delta, 2 * lr,
                           lr * 1e-8 * delta / (g - delta + 1e-8) ** 2)
        allowed = allowed + 1e-6 * np.abs(np.asarray(want[k])).max()
        d = np.abs(np.asarray(after[k], np.float64) - np.asarray(want[k], np.float64))
        assert (d <= allowed).all(), (k, d.max())


def _close_to_one_process(got, want, lr):
    """Every step's loss terms; the first step's gradients and update; the
    last parameters within AdamW's reach of lr per step."""
    for g, w in zip(got, want):
        for k in w["metrics"]:
            assert abs(g["metrics"][k] - w["metrics"][k]) <= LOSS_TOL * abs(
                w["metrics"][k]), (k, g["metrics"], w["metrics"])
    for k, w in want[0]["grads"].items():
        err = float((got[0]["grads"][k] - w).abs().max() / max(w.abs().max(), 1e-30))
        assert err <= DP_GRAD_TOL, (k, err)
    _first_update_close(got[0]["params"], want[0]["grads"],
                        want[0]["params"], lr, DP_GRAD_TOL)
    for k, w in want[-1]["params"].items():
        assert float((got[-1]["params"][k] - w).abs().max()) <= 2 * lr * len(want), k


def test_collective_gradients(world2):
    """The differentiable collectives on 2 ranks: x_s's gradient of the
    global loss (the sum of the ranks' losses) is the sum over ranks of
    what each rank's loss weights x_s by -- all_gather and psum: every
    rank's weights of x_s; the halo exchange: the right neighbour's left-
    halo weights on x_s's last h elements, the left neighbour's right-
    halo weights on its first h, nothing past the ends."""
    jobs, results = world2
    job = jobs["collectives"]
    n, h = job["n"], job["n"] // 2
    w = torch.randn((2, 3, 2, n), generator=torch.Generator().manual_seed(job["seed"]))
    for s, res in enumerate(results["collectives"]):
        got = res[0]
        want = {"all_gather": w[0, 0, s] + w[1, 0, s],
                "psum": w[0, 1, 0] + w[1, 1, 0],
                "exchange": torch.zeros(n)}
        if s + 1 < 2:
            want["exchange"][-h:] += w[s + 1, 2, 0, :h]
        if s > 0:
            want["exchange"][:h] += w[s - 1, 2, 1, :h]
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("name", ["DiffusionFast", "Sins"])
def test_data_parallel_step(world2, name):
    """2 ranks against one process over two AdamW steps (the first with
    injected draws, the second drawn from the shared seed), for a cascade
    and a DDSP synth."""
    jobs, results = world2
    ranks = results[name]
    _bit_identical(ranks)
    _close_to_one_process(ranks[0], _one_process(jobs[name]), LR)


def test_data_parallel_gan_steps(world2):
    """The vocoder's disc and gen steps at 2 ranks over two iterations:
    both models' parameters, buffers, moments and gradients bit for bit on
    the ranks (the discriminators' spectral norm keeps no state), and one
    process's within the tolerances."""
    jobs, results = world2
    _bit_identical(results["gan"])
    _close_to_one_process(results["gan"][0], _one_process(jobs["gan"]),
                          jobs["gan"]["lr"])


# ---- sequence parallel -----------------------------------------------------

def _sp_close_to_jax(res, jax_result, job):
    params, metrics, grads = jax_result
    for k, w in metrics.items():
        assert abs(res["metrics"][k] - w) <= SP_LOSS_TOL * abs(w), (k, res["metrics"], metrics)
    args = _sp_args(job["family"])
    got = leaves(moments_params(args.model, res["grads"]))
    assert set(got) == set(grads)
    for k, w in grads.items():
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= SP_GRAD_TOL, (k, err)
    after = leaves(moments_params(args.model, {
        n: p for n, p in res["params"].items() if n in res["grads"]}))
    want = {k: params[k] - LR * g / (np.abs(g) + 1e-8) for k, g in grads.items()}
    _first_update_close(after, grads, want, LR, SP_GRAD_TOL)


def _sp_invariant(res, job):
    """The port's own (1, 1) step on the same draws."""
    (want,) = run_job(dict(job, dp=1, sp=1), mesh_lib.make_mesh(1, 1, "cpu"))
    for k, w in want["metrics"].items():
        assert abs(res["metrics"][k] - w) <= LOSS_TOL * abs(w), k
    for n, w in want["grads"].items():
        err = float((res["grads"][n] - w).abs().max() / max(w.abs().max(), 1e-30))
        assert err <= SP_INV_GRAD_TOL, (n, err)


@pytest.mark.parametrize("family", ["diffusion", "reflow"])
def test_sp_step_matches_jax(world2, jax_sp, family):
    """dp x sp = 1 x 2: the port's step on 2 ranks against JAX's on a (1, 2)
    mesh, and against its own (1, 1): ranks bit for bit."""
    jobs, results = world2
    ranks = results[f"sp-{family}"]
    _bit_identical(ranks)
    _sp_close_to_jax(ranks[0][0], jax_sp[family, 1, 2], jobs[f"sp-{family}"])
    _sp_invariant(ranks[0][0], jobs[f"sp-{family}"])


def test_sp_step_2x2_matches_jax(world4, jax_sp):
    """dp x sp = 2 x 2 on 4 ranks against JAX's (2, 2) mesh."""
    job, ranks = world4
    _bit_identical(ranks)
    _sp_close_to_jax(ranks[0][0], jax_sp["diffusion", 2, 2], job)
    _sp_invariant(ranks[0][0], job)


def test_sp_step_refuses_bad_blocks():
    """JAX's asserts (train_sp.py:199-207), as errors with its messages,
    raised before any collective."""
    from ddsp_svc_tpu_torch.parallel.train_sp import make_sp_cascade_train_step as port_sp
    from ddsp_svc_tpu_torch.train.state import create_train_state

    model = random_init_(build_model(_sp_args("diffusion"), vocoder_dimension=M),
                         torch.Generator().manual_seed(0))
    mel = LogMelSpectrogram(sr=SR, n_mels=M, n_fft=256, win_size=256, hop_length=HOP)
    world = mesh_lib.make_mesh(1, 1, "cpu")
    world.dp = world.sp = 2  # a 2 x 2 mesh's checks
    step = port_sp(model, mel, world, k_step_max=100)
    state = create_train_state(model)
    x = {k: torch.as_tensor(v) for k, v in _sp_batch().items()}
    frames = ("units", "f0", "volume", "mel")
    for cut, msg in (
            ({k: v[:3] for k, v in x.items()}, "batch 3 not divisible by dp 2"),
            ({k: v[:, :191] if k in frames else v for k, v in x.items()},
             "frames 191 not divisible by sp 2"),
            ({k: v[:, :180] if k in frames else v for k, v in x.items()},
             r"time-shard of 90 frames too small \(needs >= 96\)")):
        with pytest.raises(ValueError, match=msg):
            step(state, cut)


# ---- the CLIs --------------------------------------------------------------

def _corpus(root, seconds, seed):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    for i, sec in enumerate(seconds):
        n = np.arange(int(44100 * sec))
        f = (170.0 + 25 * i) * (1 + 0.03 * np.sin(2 * np.pi * 5 * n / 44100))
        a = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / 44100) + 0.01 * rng.standard_normal(len(n))
        os.makedirs(os.path.join(root, "audio"), exist_ok=True)
        wavfile.write(os.path.join(root, "audio", f"f{i}.wav"), 44100,
                      (a * 32767).astype(np.int16))


def _cli_config(tmp, expdir, **train):
    args = tiny_config("DiffusionFast", **dict(dict(
        batch_size=2, cache_all_data=True, interval_log=1, interval_val=2,
        interval_force_save=0, save_opt=True, lr=2e-4, epochs=100000), **train))
    args["data"].update(encoder="tiny", encoder_ckpt=str(tmp / "absent.npz"),
                        encoder_out_channels=256,
                        train_path=str(tmp / "data" / "train"),
                        valid_path=str(tmp / "data" / "val"))
    args["env"]["expdir"] = str(tmp / expdir)
    path = str(tmp / f"{expdir}.yaml")
    save_config(path, args)
    return path


def test_cli_train_two_ranks(tmp_path):
    """``cli.train`` on 2 CPU ranks (torchrun's environment) for 2 steps
    against one process: rank 0 alone saves ``model_2.ckpt``, which the JAX
    package reads, with the one process's parameters within 2 lr x steps
    and AdamW's moments within MOMENT_TOL x max|leaf| (measured 1.7e-5);
    then both ranks resume from it."""
    from ddsp_svc_tpu.train.checkpoint import load_checkpoint
    from ddsp_svc_tpu_torch.cli import preprocess as pprep

    _corpus(str(tmp_path / "data" / "train"), (1.1, 0.9, 1.3), seed=1)
    _corpus(str(tmp_path / "data" / "val"), (0.8,), seed=2)
    # the ranks run without TensorFlow, as this process (torch_helpers)
    no_tf = tmp_path / "no_tf" / "tensorflow"
    no_tf.mkdir(parents=True)
    (no_tf / "__init__.py").write_text('raise ImportError("no TensorFlow")\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(no_tf.parent), str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))

    def train(expdir, nproc, steps):
        argv = ["-m", "ddsp_svc_tpu_torch.cli.train", "-c", _cli_config(tmp_path, expdir),
                "--device", "cpu", "--max_steps", str(steps)]
        return launch.launch(argv, nproc, WALL, env=env, cwd=str(ROOT))

    one = _cli_config(tmp_path, "one")
    pprep.main(["-c", one, "--device", "cpu", "--seed", "3"])
    ptrain.main(["-c", one, "--device", "cpu", "--max_steps", "2"])  # one process
    outs = train("two", 2, 2)
    assert "model saved" in outs[0] and "model saved" not in outs[1]
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))
    (p1, s1), (p2, s2) = (load_checkpoint(str(tmp_path / d / "model_2.ckpt"))
                          for d in ("one", "two"))
    assert s1 == s2 == 2
    for part, tol in (("params", None), ("opt_state", MOMENT_TOL)):
        want, got = leaves(p1[part]), leaves(p2[part])
        assert want.keys() == got.keys()
        for k, w in want.items():
            d = np.abs(np.asarray(got[k], np.float64) - np.asarray(w, np.float64))
            if tol is None:
                assert d.max() <= 2 * 2e-4 * 2, k
            else:
                assert d.max() <= tol * max(np.abs(w).max(), 1e-30), (k, d.max())
    for out in train("two", 2, 2):
        assert "model_2.ckpt (step 2)" in out
    assert (tmp_path / "two" / "model_4.ckpt").exists()


def test_launch_refusals(tmp_path, monkeypatch):
    """A batch the world does not divide is refused by both trainers
    before any model is built (JAX drops devices; a launched rank cannot be
    dropped), and ``JAX_COORDINATOR_ADDRESS`` without torchrun's
    environment by ``cli.train``, in words that name torchrun."""
    cfg = _cli_config(tmp_path, "exp", batch_size=3)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node N"):
        ptrain.main(["-c", cfg, "--device", "cpu"])
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    for main in (ptrain.main, pvoc.main):
        with pytest.raises(SystemExit, match="batch_size 3 is not divisible by "
                                             "the 2 ranks"):
            main(["-c", cfg, "--device", "cpu"])
