"""The training entry points end to end on the CPU: ``cli.preprocess`` on a
small corpus, then ``cli.train`` (``--device cpu``) warm-started from a
``model_0`` the JAX package wrote, three steps whose losses match the JAX
loop's on the same batches, parameters and draws, a save, a resume at the
right step with the learning rate the schedule gives there, retention, and
the refusal of ``JAX_COORDINATOR_ADDRESS`` without torchrun's environment;
``model.use_remat: true`` training; and a bf16 mixed-precision run
(``amp_dtype: bf16``, fp16 mapped to it as JAX maps it) that trains,
saves float32 parameters the JAX package reads, and resumes.

Tolerance of the losses: step 1 starts from the same parameters, 1e-5
relative. AdamW's first updates are about lr x sign(g) per element, so an
element whose gradient the two packages round to opposite signs moves by
2 lr; at the configs' rate (2e-4) steps 2 and 3 stay within 2.8e-6
relative over four preprocess seeds (at 2e-3: up to 1.2e-3), and are held
at 1e-4. The preprocess draws are seeded (``--seed 3``)."""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.data.dataset as jds
from ddsp_svc_tpu.models.registry import build_model as jax_build_model
from ddsp_svc_tpu.train.checkpoint import save_checkpoint as jax_save
from ddsp_svc_tpu.train.state import create_train_state as jax_train_state
from ddsp_svc_tpu_torch.cli import preprocess as pprep
from ddsp_svc_tpu_torch.cli import train as ptrain
from ddsp_svc_tpu_torch.train import solver
from ddsp_svc_tpu_torch.train.checkpoint import latest_checkpoint
from ddsp_svc_tpu_torch.utils.config import save_config
from torch_train_helpers import jax_mel_fn, jax_variables, tiny_config

SR, HOP, STEPS, LR = 44100, 512, 3, 2e-4


def _corpus(root, seconds, seed):
    rng = np.random.default_rng(seed)
    for i, sec in enumerate(seconds):
        n = np.arange(int(SR * sec))
        f = (170.0 + 25 * i) * (1 + 0.03 * np.sin(2 * np.pi * 5 * n / SR))
        a = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / SR) + 0.01 * rng.standard_normal(len(n))
        path = os.path.join(root, "audio", f"f{i}.wav")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wavfile.write(path, SR, (a * 32767).astype(np.int16))


def _config(tmp_path, **train):
    args = tiny_config("DiffusionFast", **dict(dict(
        batch_size=2, cache_all_data=True, interval_log=1, interval_val=STEPS,
        interval_force_save=0, save_opt=True, decay_step=4, gamma=0.5, lr=LR,
        weight_decay=0.01, epochs=100000, amp_dtype="fp32"), **train))
    args["data"].update(encoder="tiny", encoder_ckpt=str(tmp_path / "absent.npz"),
                        encoder_out_channels=256,
                        train_path=str(tmp_path / "data" / "train"),
                        valid_path=str(tmp_path / "data" / "val"))
    args["env"]["expdir"] = str(tmp_path / "exp")
    path = str(tmp_path / "config.yaml")
    save_config(path, args)
    return args, path


def _draws(step, b, t):
    """The draws of step ``step``: the synth noise, and the diffusion t and
    noise as JAX draws them from the step's key."""
    rng = np.random.default_rng(100 + step)
    key = jax.random.PRNGKey(200 + step)
    key_t, key_n = jax.random.split(key)
    return key, {
        "ddsp_noise": rng.standard_normal((b, t * HOP)).astype(np.float32),
        "t": np.asarray(jax.random.randint(key_t, (b,), 0, 100)),
        "noise": np.asarray(jax.random.normal(key_n, (b, t, 128), jnp.float32))}


def _jax_losses(args, params, n):
    """The JAX loop with the same draws: its sampler and model, AdamW."""
    train_ds, _ = jds.get_datasets(args)
    sampler = jds.BatchSampler(train_ds, 2, seed=0)
    model = jax_build_model(args)
    state = jax_train_state(model, params, lr=LR, weight_decay=0.01,
                            decay_step=4, gamma=0.5)
    mel = jax_mel_fn()

    def loss_fn(p, batch, key, ddsp_noise):
        ddsp_loss, diff_loss = model.apply(
            {"params": p}, batch["units"], batch["f0"], batch["volume"],
            aug_shift=batch["aug_shift"], mel_extract_fn=mel,
            gt_spec=batch["mel"], infer=False, key=key, k_step=100,
            deterministic=True, ddsp_noise=ddsp_noise)
        return ddsp_loss + diff_loss

    # one compile for every step (the step's batch, key and draws as
    # arguments; each batch has the same shapes)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    out = []
    for step in range(n):
        batch = {k: jnp.asarray(v) for k, v in sampler.sample().items()}
        key, d = _draws(step, 2, batch["units"].shape[1])
        loss, grads = grad_fn(state.params, batch, key, jnp.asarray(d["ddsp_noise"]))
        state = state.apply_gradients(grads)
        out.append(float(loss))
    return out


def test_preprocess_train_resume(tmp_path, monkeypatch):
    _corpus(str(tmp_path / "data" / "train"), (1.1, 0.9, 1.3), seed=1)
    _corpus(str(tmp_path / "data" / "val"), (0.8,), seed=2)
    args, cfg = _config(tmp_path)
    pprep.main(["-c", cfg, "--device", "cpu", "--seed", "3"])
    for kind in ("units", "f0", "volume", "mel", "aug_mel", "aug_vol"):
        assert len(os.listdir(tmp_path / "data" / "train" / kind)) == 3, kind
    assert os.path.exists(tmp_path / "data" / "train" / "pitch_aug_dict.npy")

    jmodel = jax_build_model(args)
    params = jax_variables(args, jmodel, seed=9, shapes_only=True)["params"]
    jax_save(str(tmp_path / "exp"), 0, params)  # model_0: the warm start
    want = _jax_losses(args, params, STEPS)

    got, original = [], solver.build_train_step

    def injecting(args_, mel_fn, mesh=None):
        family, step = original(args_, mel_fn, mesh)

        def wrapped(state, batch, generator=None, draws=None):
            _, d = _draws(state.step, *batch["units"].shape[:2])
            metrics = step(state, batch, generator,
                           {k: torch.from_numpy(v) for k, v in d.items()})
            got.append(float(metrics["loss"]))
            return metrics
        return family, wrapped

    monkeypatch.setattr(solver, "build_train_step", injecting)
    state = ptrain.main(["-c", cfg, "--device", "cpu", "--max_steps", str(STEPS)])
    assert state.step == STEPS and len(got) == STEPS
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
    for g, w in zip(got[1:], want[1:]):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)
    exp = tmp_path / "exp"
    assert latest_checkpoint(str(exp)).endswith(f"model_{STEPS}.ckpt")
    log = (exp / "log_info.txt").read_text()
    assert "validation" in log and "step: 3" in log

    # resume: the newest checkpoint, its step, the optimizer state, and the
    # rate at steps 4-6 (lr x 0.5 from step 4)
    state = ptrain.main(["-c", cfg, "--device", "cpu", "--max_steps", str(STEPS)])
    assert state.step == 2 * STEPS
    assert state.lr() == pytest.approx(LR * 0.5)
    assert float(next(iter(state.optimizer.state.values()))["step"]) == 2 * STEPS
    # each run keeps its own last save, as the JAX loop does
    assert sorted(f for f in os.listdir(exp) if f.endswith(".ckpt")) == [
        "model_0.ckpt", f"model_{STEPS}.ckpt", f"model_{2 * STEPS}.ckpt"]
    assert len(got) == 2 * STEPS


def test_refusals(tmp_path, monkeypatch, capsys):
    """``JAX_COORDINATOR_ADDRESS`` without torchrun's environment is
    refused, naming torchrun, before any model is built (the port's
    multi-process launch is torchrun's: tests/test_torch_train_dist.py).
    bf16 mixed precision is not refused any more:
    ``amp_dtype`` bf16 / bfloat16 map to bfloat16, fp16 / float16 too with
    the JAX trainer's notice, fp32 to float32."""
    for amp, want in (("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
                      ("fp16", torch.bfloat16), ("fp32", None)):
        args, _ = _config(tmp_path, amp_dtype=amp)
        assert ptrain.amp_dtype(args) is want, amp
    assert "fp16 requested; using bf16" in capsys.readouterr().out
    _, cfg = _config(tmp_path)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(SystemExit, match=r"launch the ranks with torchrun"):
        ptrain.main(["-c", cfg, "--device", "cpu"])


def test_use_remat_refused(tmp_path):
    """``model.use_remat: true`` is no longer refused (ROADMAP A item 14 is
    ported): ``cli.train`` builds the denoiser with ``remat``, trains and
    saves a checkpoint the JAX package restores strictly."""
    from ddsp_svc_tpu.train.checkpoint import load_checkpoint, restore_into

    _corpus(str(tmp_path / "data" / "train"), (1.1, 0.9), seed=1)
    _corpus(str(tmp_path / "data" / "val"), (0.8,), seed=2)
    args, cfg = _config(tmp_path, interval_val=2)
    args["model"]["use_remat"] = True
    save_config(cfg, args)
    pprep.main(["-c", cfg, "--device", "cpu", "--seed", "3"])
    state = ptrain.main(["-c", cfg, "--device", "cpu", "--max_steps", "2"])
    assert state.step == 2 and state.model.denoise_fn.remat
    payload, step = load_checkpoint(latest_checkpoint(str(tmp_path / "exp")))
    jmodel = jax_build_model(args)
    params = jax_variables(args, jmodel, seed=9, shapes_only=True)["params"]
    restore_into(params, payload["params"], strict=True)
    assert step == 2


def test_bf16_config_trains(tmp_path):
    """``cli.train`` with ``amp_dtype: bf16``: the model's layers compute in
    bf16 (the trunk's activations are bf16, through B5's plain version on
    the CPU), the parameters, the optimizer state and the checkpoint stay
    float32 and the JAX package restores it strictly; the run resumes from
    its save. The first loss is within 2 % of the f32 run's from the same
    warm start and batch (bf16's rounding of the synth and the trunk)."""
    from ddsp_svc_tpu.train.checkpoint import load_checkpoint, restore_into

    _corpus(str(tmp_path / "data" / "train"), (1.1, 0.9), seed=1)
    _corpus(str(tmp_path / "data" / "val"), (0.8,), seed=2)
    args, cfg = _config(tmp_path, amp_dtype="bf16", interval_val=2)
    pprep.main(["-c", cfg, "--device", "cpu", "--seed", "3"])
    jmodel = jax_build_model(args)
    params = jax_variables(args, jmodel, seed=9, shapes_only=True)["params"]
    jax_save(str(tmp_path / "exp"), 0, params)
    losses = {}
    original = solver.build_train_step

    def recording(tag):
        def build(args_, mel_fn, mesh=None):
            family, step = original(args_, mel_fn, mesh)

            def wrapped(state, batch, generator=None, draws=None):
                _, d = _draws(state.step, *batch["units"].shape[:2])
                out = step(state, batch, generator,
                           {k: torch.from_numpy(v) for k, v in d.items()})
                losses.setdefault(tag, []).append(float(out["loss"]))
                dtypes = {p.dtype for p in state.model.parameters()}
                assert dtypes == {torch.float32}, dtypes
                return out
            return family, wrapped
        return build

    solver.build_train_step = recording("bf16")
    try:
        state = ptrain.main(["-c", cfg, "--device", "cpu", "--max_steps", "2"])
        net = state.model.denoise_fn
        assert net.input_projection.compute_dtype is torch.bfloat16
        spec = torch.zeros(1, 4, 128)
        assert net(spec, torch.tensor([5.0]), spec).dtype == torch.bfloat16
        path = latest_checkpoint(str(tmp_path / "exp"))
        assert path.endswith("model_2.ckpt")
        payload, step = load_checkpoint(path)
        assert step == 2
        restore_into(jax.device_get(params), payload["params"], strict=True)
        leaves = jax.tree_util.tree_leaves(payload["params"])
        assert all(np.asarray(v).dtype == np.float32 for v in leaves)
        state = ptrain.main(["-c", cfg, "--device", "cpu", "--max_steps", "1"])
        assert state.step == 3
    finally:
        solver.build_train_step = original
    assert all(np.isfinite(losses["bf16"]))
    (tmp_path / "exp2").mkdir()
    args32, cfg32 = _config(tmp_path, amp_dtype="fp32")
    args32["env"]["expdir"] = str(tmp_path / "exp2")
    save_config(cfg32, args32)
    jax_save(str(tmp_path / "exp2"), 0, params)
    solver.build_train_step = recording("f32")
    try:
        ptrain.main(["-c", cfg32, "--device", "cpu", "--max_steps", "1"])
    finally:
        solver.build_train_step = original
    assert abs(losses["bf16"][0] - losses["f32"][0]) <= 0.02 * abs(losses["f32"][0])
