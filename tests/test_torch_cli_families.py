"""The port's CLIs against the JAX package's on checkpoints of the families
this slice adds, written by the JAX package's own ``save_checkpoint`` and
``save_config`` (the helpers of tests/test_torch_cli.py), with one
NSF-HiFiGAN payload (32 channels) that both sides read:

- a RectifiedFlow checkpoint with ``-step 4 -ts 0.8 -method rk4`` and the
  formant shift ``-fs``, through both offline CLIs;
- a Diffusion (Unit2Mel) checkpoint with ``-mix``, ``-fs`` and ``-ddsp``
  (an external CombSubSuperFast seeding the diffusion at ``-kstep``),
  through both offline CLIs;
- the DDSP checkpoint of tests/test_torch_cli.py (its noise filter off)
  through both realtime CLIs in file mode.

The random draws are the same on both sides: the JAX models' ``apply``
and vocoder get them injected, and the port's modules through forward
pre-hooks, each draw made from numpy by its shape. Each pair of wavs
agrees to >= 40 dB SNR, with the same length and rate."""
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp
from flax import serialization

import ddsp_svc_tpu.cli.infer as jcli
import ddsp_svc_tpu.cli.realtime as jrt_cli
import ddsp_svc_tpu.models.vocoder as jvoc
import ddsp_svc_tpu_torch.cli.infer as pcli
import ddsp_svc_tpu_torch.cli.realtime as prt_cli
import ddsp_svc_tpu_torch.models.registry as preg
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu.train.checkpoint import save_checkpoint
from ddsp_svc_tpu.utils.config import save_config
from test_torch_cli import N_UNIT, _data, _encoder_npz, _write_wav, ddsp_ckpt  # noqa: F401
from torch_helpers import randomize_tree, snr_db

SR, BLOCK, WIN = 44100, 512, 2048
VOC = dict(upsample_initial_channel=32)
KINDS = {"init": 1, "ddsp": 2, "sine": 3, "rand_ini": 4}


def _draw(kind: str, shape: tuple) -> np.ndarray:
    """The draw of ``kind`` at ``shape``, the same on both sides."""
    rng = np.random.default_rng(1000 * KINDS[kind] + int(np.prod(shape)) % 9973)
    if kind == "rand_ini":
        return np.concatenate([[0.0], rng.random(8)]).astype(np.float32)[None, None]
    return rng.standard_normal(shape).astype(np.float32)


# the noise keywords each model type draws: (keyword, kind)
NOISE_KW = {"RectifiedFlow": (("init_noise", "init"), ("ddsp_noise", "ddsp")),
            "Diffusion": (("init_noise", "init"),),
            "CombSubSuperFast": (("noise", "ddsp"),)}


def _shape(kind, t):
    return (1, t, 128) if kind == "init" else (1, t * BLOCK)


class JNoisy:
    """A JAX model whose ``apply`` gets its draws injected."""

    def __init__(self, module, mtype):
        self.module, self.mtype = module, mtype

    def apply(self, variables, units, *args, **kwargs):
        t = units.shape[1]
        for kw, kind in NOISE_KW[self.mtype]:
            kwargs[kw] = jnp.asarray(_draw(kind, _shape(kind, t)))
        return self.module.apply(variables, units, *args, **kwargs)


class JNoisyVocoder(jvoc.Vocoder):
    """The JAX vocoder with the sine source's draws injected."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._infer = lambda p, mel, f0, key: self.model.apply(
            {"params": p}, mel, f0, sine_kwargs=dict(
                rand_ini=jnp.asarray(_draw("rand_ini", (1, 1, 9))),
                noise=jnp.asarray(_draw("sine", (1, mel.shape[1] * BLOCK, 9)))))


def _port_noise_hook(module, mtype):
    def hook(mod, args, kwargs):
        t = args[0].shape[1]
        for kw, kind in NOISE_KW[mtype]:
            if kwargs.get(kw) is None:
                kwargs[kw] = torch.from_numpy(_draw(kind, _shape(kind, t)))
        return args, kwargs
    module.register_forward_pre_hook(hook, with_kwargs=True)


def _port_sine_hook(mod, args):
    mel, f0, _, generator = args
    return mel, f0, dict(
        rand_ini=torch.from_numpy(_draw("rand_ini", (1, 1, 9))),
        noise=torch.from_numpy(_draw("sine", (1, mel.shape[1] * BLOCK, 9)))), generator


@pytest.fixture
def noisy_sides(monkeypatch):
    """Inject the draws into both CLIs' models and vocoders."""
    j_load = jcli.load_model

    def j_load_noisy(path):
        model, variables, args = j_load(path)
        return JNoisy(model, args.model.type), variables, args

    monkeypatch.setattr(jcli, "load_model", j_load_noisy)
    monkeypatch.setattr(jcli, "Vocoder", JNoisyVocoder)
    p_load, p_voc = preg.load_model, preg.load_vocoder_or_random

    def p_load_noisy(path, device=None):
        model, args = p_load(path, device)
        _port_noise_hook(model, args.model.type)
        return model, args

    def p_voc_noisy(*args, **kwargs):
        vocoder = p_voc(*args, **kwargs)
        vocoder.model.register_forward_pre_hook(_port_sine_hook)
        return vocoder

    monkeypatch.setattr(preg, "load_model", p_load_noisy)
    monkeypatch.setattr(preg, "load_vocoder_or_random", p_voc_noisy)


def _vocoder_payload(path):
    jg = JGenerator(SR, 128, **VOC)
    params = randomize_tree(jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"]), seed=80)
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize({"params": params, "config": VOC}))
    return str(path)


def _checkpoint(d, module, model_cfg, seed, step, vocoder=None, **init_kw):
    t = 8
    params = randomize_tree(jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, N_UNIT)), jnp.full((1, t, 1), 220.0),
        jnp.ones((1, t, 1)), spk_id=jnp.ones((1, 1), jnp.int32),
        **init_kw)["params"]), seed=seed)
    save_checkpoint(str(d), step, params)
    cfg = {"data": _data(SR, BLOCK, _encoder_npz(d / "encoder.npz")),
           "model": model_cfg, "infer": {}}
    if vocoder:
        cfg["vocoder"] = {"type": "nsf-hifigan", "ckpt": vocoder}
    save_config(d / "config.yaml", cfg)
    return str(d / f"model_{step}.ckpt")


def _both(tmp_path, argv, port_main=pcli.main, jax_main=jcli.main):
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        (tmp_path / name).mkdir()
        out = tmp_path / name / "out.wav"
        main(argv + ["-o", str(out)] + (["--device", "cpu"] if name == "port" else []))
        outs[name] = wavfile.read(out)
    (sr_j, want), (sr_p, got) = outs["jax"], outs["port"]
    assert sr_p == sr_j
    assert got.shape == want.shape and np.abs(got).max() > 0
    return snr_db(want.astype(np.float64), got.astype(np.float64))


def test_reflow_cli_matches_jax(tmp_path, noisy_sides):
    from ddsp_svc_tpu.models.cascade import ReflowUnit2Wav

    voc = _vocoder_payload(tmp_path / "voc.msgpack")
    module = ReflowUnit2Wav(SR, BLOCK, WIN, N_UNIT, 2, True, 128, 2, 16)
    ckpt = _checkpoint(tmp_path / "reflow", module, {
        "type": "RectifiedFlow", "win_length": WIN, "n_layers": 2, "n_chans": 16,
        "use_pitch_aug": True, "n_spk": 2, "t_start": 0.7}, 81, 3, voc,
        aug_shift=jnp.zeros((1, 1, 1)), mel_extract_fn=JLogMel().extract,
        gt_spec=jnp.zeros((1, 8, 128)), infer=False, key=jax.random.PRNGKey(2))
    in_wav = tmp_path / "in.wav"
    _write_wav(in_wav, SR, 0.5)
    snr = _both(tmp_path, ["-m", ckpt, "-i", str(in_wav), "-id", "2", "-step",
                           "4", "-ts", "0.8", "-method", "rk4", "-fs", "2"])
    print(f"reflow CLI SNR vs the JAX CLI: {snr:.1f} dB")
    assert snr >= 40.0


def test_unit2mel_cli_with_mix_fs_and_ddsp_matches_jax(tmp_path, noisy_sides):
    from ddsp_svc_tpu.models.cascade import Unit2Mel
    from ddsp_svc_tpu.models.ddsp import CombSubSuperFast

    voc = _vocoder_payload(tmp_path / "voc.msgpack")
    ckpt = _checkpoint(tmp_path / "diff", Unit2Mel(N_UNIT, 2, True, 128, 2, 16, 16,
                                                   k_step_max=20), {
        "type": "Diffusion", "n_layers": 2, "n_chans": 16, "n_hidden": 16,
        "use_pitch_aug": True, "n_spk": 2, "k_step_max": 20}, 82, 4, voc,
        aug_shift=jnp.zeros((1, 1, 1)), gt_spec=jnp.zeros((1, 8, 128)),
        infer=False, key=jax.random.PRNGKey(2))
    ddsp = _checkpoint(tmp_path / "ddsp", CombSubSuperFast(SR, BLOCK, WIN, N_UNIT, 2),
                       {"type": "CombSubSuperFast", "win_length": WIN, "n_spk": 2},
                       83, 5)
    in_wav = tmp_path / "in.wav"
    _write_wav(in_wav, SR, 0.5)
    snr = _both(tmp_path, ["-m", ckpt, "-i", str(in_wav), "-mix", "{2: 0.6, 1: 0.4}",
                           "-fs", "3", "-ddsp", ddsp, "-kstep", "10", "-speedup", "5"])
    print(f"Unit2Mel CLI (-mix, -fs, -ddsp) SNR vs the JAX CLI: {snr:.1f} dB")
    assert snr >= 40.0


def test_realtime_cli_file_mode_matches_jax(tmp_path, ddsp_ckpt):  # noqa: F811
    in_wav = tmp_path / "in.wav"
    _write_wav(in_wav, 16000, 2.0)
    snr = _both(tmp_path, ["-m", str(ddsp_ckpt), "-i", str(in_wav), "-k", "1",
                           "--block_time", "0.25", "--extra_time", "0.75"],
                port_main=prt_cli.main, jax_main=jrt_cli.main)
    print(f"realtime CLI SNR vs the JAX realtime CLI: {snr:.1f} dB")
    assert snr >= 40.0

