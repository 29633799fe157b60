"""NSF-HiFiGAN training's checkpoint and CLI against the JAX package: the
port's payload restored strictly by the JAX package (params and optax
states) and the JAX package's payload loaded by the port; and
``cli.train_vocoder`` on a small preprocessed corpus, saving, resuming,
and refusing a config with no discriminator."""
import os

import jax
import numpy as np
import optax
import pytest

from ddsp_svc_tpu.train import vocoder_solver as jsolver
from ddsp_svc_tpu_torch.io.jax_params import vocoder_train_params
from ddsp_svc_tpu_torch.train import vocoder_solver as psolver
from test_torch_vocoder_train import (CFG, MSD, PERIODS, _generator_jax, _setup,
                                      _t, psolver_generator)
from torch_train_helpers import leaves


def test_checkpoint_both_ways(tmp_path):
    """The port's payload restores strictly into the JAX recipe's params
    and optax states; a payload the JAX CLI writes loads into the port."""
    from ddsp_svc_tpu.train import checkpoint as jckpt
    from ddsp_svc_tpu_torch.cli.train_vocoder import save
    from ddsp_svc_tpu_torch.train.checkpoint import load_checkpoint

    jgen, jdisc, gparams, dparams, gen, discs, batch, sine = _setup(seed=3)
    state_g, state_d = psolver.create_states(gen, discs, 1e-3)
    psolver.disc_step(state_d, gen, _t(batch), sine_kwargs=_t(sine))
    path = save(str(tmp_path), psolver.vocoder_payload(state_g, state_d, CFG, 1))
    payload, step = jckpt.load_checkpoint(path)
    assert step == 1
    for key, tmpl in (("generator", gparams), ("discriminator", dparams)):
        jckpt.restore_into(jax.device_get(tmpl), payload["params"][key], strict=True)
        tx = optax.adamw(1e-3, b1=0.8, b2=0.99)
        from flax import serialization
        serialization.from_state_dict(tx.init(tmpl), payload["opt_state"][key])
    assert int(payload["opt_state"]["discriminator"]["0"]["count"]) == 1

    tx = optax.adamw(1e-3, b1=0.8, b2=0.99)
    opt_d = tx.init(dparams)
    jpath = jckpt.save_checkpoint(
        str(tmp_path / "j"), 7, {"generator": gparams, "discriminator": dparams},
        opt_state={"generator": tx.init(gparams), "discriminator": opt_d})
    payload, _ = load_checkpoint(jpath)
    fresh_g, fresh_d = psolver_generator(), psolver.Discriminators(PERIODS, MSD)
    sg, sd = psolver.create_states(fresh_g, fresh_d, 1e-3)
    psolver.restore_payload(sg, sd, CFG, payload)
    got = vocoder_train_params(fresh_g.state_dict(), fresh_d.state_dict(), CFG,
                               PERIODS, MSD)
    for key, tmpl in (("generator", gparams), ("discriminator", dparams)):
        want, have = leaves(tmpl), leaves(got[key])
        assert set(want) == set(have) and all(np.array_equal(want[k], have[k])
                                               for k in want)
    assert sg.step == 0 and sd.step == 0


def _zeros(shapes):
    """A params template of zeros from ``jax.eval_shape``'s tree."""
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def _corpus(root, seconds, seed, sr=44100):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    for i, sec in enumerate(seconds):
        n = np.arange(int(sr * sec))
        f = 180.0 + 20 * i
        a = 0.3 * np.sin(2 * np.pi * f * n / sr) + 0.01 * rng.standard_normal(len(n))
        path = os.path.join(root, "audio", f"f{i}.wav")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wavfile.write(path, sr, (a * 32767).astype(np.int16))


def _vocoder_config(tmp_path, **vocoder):
    """The CLI's config: the data at 44.1 kHz with a hop of 4 samples (the
    generator's rates (2, 2)), the preprocess's 128-band mels, the loss's
    mel on CFG's small FFT."""
    from ddsp_svc_tpu_torch.utils.config import DotDict, save_config

    voc = {k: (list(map(list, v)) if k == "resblock_dilation_sizes" else
               list(v) if isinstance(v, tuple) else v)
           for k, v in CFG.items() if k not in ("sampling_rate", "hop_size")}
    voc.update(num_mels=128, discriminator_periods=list(PERIODS), msd_scales=MSD)
    voc.update(vocoder)
    args = DotDict({
        "data": {"sampling_rate": 44100, "block_size": 4, "duration": 0.01,
                 "encoder": "tiny", "encoder_ckpt": str(tmp_path / "absent.npz"),
                 "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "encoder_out_channels": 256, "f0_extractor": "yin",
                 "f0_min": 65, "f0_max": 800, "extensions": ["wav"],
                 "train_path": str(tmp_path / "data" / "train"),
                 "valid_path": str(tmp_path / "data" / "val")},
        "model": {"type": "DiffusionFast", "win_length": 64, "n_spk": 1,
                  "use_pitch_aug": False},
        "vocoder": voc,
        "train": {"batch_size": 2, "cache_all_data": True, "epochs": 100000,
                  "interval_log": 1, "interval_val": 2, "lr": 2e-4, "seed": 0},
        "env": {"expdir": str(tmp_path / "exp")}})
    path = str(tmp_path / "config.yaml")
    save_config(path, args)
    return args, path


def test_train_vocoder_cli_saves_and_resumes(tmp_path, capsys):
    """``cli.train_vocoder.main`` on a small preprocessed corpus (the
    diffusion preprocess's audio, f0 and mel): two steps and a save whose
    params and optimizer states the JAX package restores strictly, then a
    resume from it to step 3 with both optimizer states; ``--help`` says
    ``--fused_resblocks`` changes nothing; both discriminators off is
    refused."""
    from ddsp_svc_tpu.train import checkpoint as jckpt
    from ddsp_svc_tpu_torch.cli import preprocess as pprep
    from ddsp_svc_tpu_torch.cli import train_vocoder as ptv
    from ddsp_svc_tpu_torch.train.checkpoint import latest_checkpoint

    _corpus(str(tmp_path / "data" / "train"), (0.12, 0.1), seed=1)
    _corpus(str(tmp_path / "data" / "val"), (0.1,), seed=2)
    args, cfg = _vocoder_config(tmp_path)
    pprep.main(["-c", cfg, "--device", "cpu", "--seed", "3"])
    state_g, state_d = ptv.main(["-c", cfg, "--device", "cpu", "--max_steps", "2",
                                 "--fused_resblocks"])
    assert state_g.step == 2 and state_d.step == 2
    path = latest_checkpoint(str(tmp_path / "exp"))
    assert path.endswith("model_2.ckpt")
    payload, step = jckpt.load_checkpoint(path)
    assert step == 2
    x = np.zeros((1, 8, 128), np.float32)
    audio = np.zeros((1, 32), np.float32)
    gparams, dparams = (_zeros(jax.eval_shape(f)["params"]) for f in (
        lambda: _generator_jax(128).init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(2)},
            x, np.zeros((1, 8), np.float32)),
        lambda: jsolver.Discriminators(PERIODS, MSD).init(
            jax.random.PRNGKey(1), audio, audio)))
    for key, tmpl in (("generator", gparams), ("discriminator", dparams)):
        jckpt.restore_into(jax.device_get(tmpl), payload["params"][key], strict=True)
    assert "d: " in (tmp_path / "exp" / "log_info.txt").read_text()
    state_g, state_d = ptv.main(["-c", cfg, "--device", "cpu", "--max_steps", "1"])
    assert state_g.step == 3 and state_d.step == 3
    with pytest.raises(SystemExit):
        ptv.main(["--help"])
    assert "K2" in capsys.readouterr().out
    _, cfg = _vocoder_config(tmp_path, discriminator_periods=[], msd_scales=0)
    with pytest.raises(SystemExit, match="disables every sub-discriminator"):
        ptv.main(["-c", cfg, "--device", "cpu"])
