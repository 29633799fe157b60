"""The WaveNet families -- ``cascade.Unit2Mel`` (type Diffusion) and
``cascade.Unit2Wav`` (DiffusionNew) -- with their WaveNet, the mel
extractor's keyshift and speed, the 'nsf-hifigan-log10' vocoder and a
ResBlock2 generator, against the JAX package at small widths (2 WaveNet
layers x 32 channels, T = 40), the same randomised params (the WaveNet's
zero-initialised output projection included) and the same injected noise.
The JAX cascades run eagerly: Unit2Wav's CombSubFast carries the phase
arithmetic that jitted XLA rounds differently (ROADMAP C(h)).

Tolerances, relative to the reference's max|out|: the WaveNet, both
cascades' mels (from noise, shallow from a given mel, with a speaker mix)
and the mel extractor 1e-5; the log10 vocoder's mel 1e-5 and its audio and
the ResBlock2 generator's 1e-5; each family's audio through
``SvcPipeline.infer_features`` >= 40 dB SNR against the JAX mel through
the JAX generator with the same sine draws."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.models.vocoder as jvoc
from ddsp_svc_tpu.models.cascade import Unit2Mel as JUnit2Mel
from ddsp_svc_tpu.models.cascade import Unit2Wav as JUnit2Wav
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.models.wavenet import WaveNet as JWaveNet
from ddsp_svc_tpu.ops.interp import upsample as j_upsample
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io.jax_params import (generator_state_dict, load_state,
                                              unit2mel_state_dict,
                                              unit2wav_state_dict,
                                              wavenet_state_dict)
from ddsp_svc_tpu_torch.models.cascade import Unit2Mel, Unit2Wav
from ddsp_svc_tpu_torch.models.vocoder import Vocoder
from ddsp_svc_tpu_torch.models.wavenet import WaveNet
from ddsp_svc_tpu_torch.ops.mel import LogMelSpectrogram
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_helpers import f0_contour, randomize_tree, rel_err, snr_db, tt

SR, BLOCK, N_UNIT, N_LAYERS, N_CHANS, N_HIDDEN, K_MAX, T = (
    44100, 512, 64, 2, 32, 24, 100, 40)
MIX = {2: 0.7, 1: 0.3}
KEYS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
        "diffusion": jax.random.PRNGKey(2)}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(units=rng.standard_normal((1, T, N_UNIT)).astype(np.float32),
                f0=f0_contour(T),
                volume=rng.uniform(0.05, 0.3, (1, T, 1)).astype(np.float32),
                ddsp_noise=rng.uniform(-1, 1, (1, T * BLOCK)).astype(np.float32),
                init_noise=rng.standard_normal((1, T, 128)).astype(np.float32),
                gt_spec=rng.uniform(-8, 0, (1, T, 128)).astype(np.float32))


def test_wavenet_matches():
    jw = JWaveNet(128, N_LAYERS, N_CHANS, N_HIDDEN)
    rng = np.random.default_rng(50)
    spec = rng.standard_normal((2, T, 128)).astype(np.float32)
    step = np.array([3.0, 517.0], np.float32)
    cond = rng.standard_normal((2, T, N_HIDDEN)).astype(np.float32)
    params = randomize_tree(jax.eval_shape(lambda: jw.init(
        KEYS["params"], jnp.asarray(spec), jnp.asarray(step),
        jnp.asarray(cond))["params"]), seed=51)
    want = jw.apply({"params": params}, *map(jnp.asarray, (spec, step, cond)))
    port = WaveNet(128, N_LAYERS, N_CHANS, N_HIDDEN)
    load_state(port, wavenet_state_dict(params, N_LAYERS))
    with torch.no_grad():
        got = port(tt(spec), tt(step), tt(cond))
    assert np.abs(np.asarray(want)).max() > 0
    assert rel_err(got, want) <= 1e-5


@pytest.fixture(scope="module")
def unit2mel():
    jm = JUnit2Mel(N_UNIT, 2, True, 128, N_LAYERS, N_CHANS, N_HIDDEN,
                   k_step_max=K_MAX)
    shapes = jax.eval_shape(lambda: jm.init(
        KEYS, jnp.zeros((1, 8, N_UNIT)), jnp.full((1, 8, 1), 220.0),
        jnp.ones((1, 8, 1)), spk_id=jnp.ones((1, 1), jnp.int32),
        aug_shift=jnp.zeros((1, 1, 1)), gt_spec=jnp.zeros((1, 8, 128)),
        infer=False, key=jax.random.PRNGKey(3))["params"])
    params = randomize_tree(shapes, seed=52)
    assert "aug_shift_embed" in params
    port = Unit2Mel(N_UNIT, 2, True, 128, N_LAYERS, N_CHANS, N_HIDDEN, K_MAX)
    load_state(port, unit2mel_state_dict(params, N_LAYERS))
    return jm, params, port.eval()


@pytest.fixture(scope="module")
def unit2wav():
    jm = JUnit2Wav(SR, BLOCK, N_UNIT, 2, True, 128, N_LAYERS, N_CHANS,
                   k_step_max=K_MAX)
    variables = jax.jit(lambda: jm.init(
        KEYS, jnp.zeros((1, 8, N_UNIT)), jnp.full((1, 8, 1), 220.0),
        jnp.ones((1, 8, 1)), spk_id=jnp.ones((1, 1), jnp.int32),
        aug_shift=jnp.zeros((1, 1, 1)), mel_extract_fn=JLogMel().extract,
        gt_spec=jnp.zeros((1, 8, 128)), infer=False,
        key=jax.random.PRNGKey(3)))()
    params = randomize_tree(variables["params"], seed=53)
    buffers = jax.device_get(variables["buffers"])
    port = Unit2Wav(SR, BLOCK, N_UNIT, 2, True, 128, N_LAYERS, N_CHANS,
                    k_step_max=K_MAX)
    load_state(port, unit2wav_state_dict(params, buffers, N_LAYERS))
    return jm, {"params": params, "buffers": buffers}, port.eval()


def _spk(mix):
    return (dict(spk_mix_dict=MIX) if mix
            else dict(spk_id=np.array([[2]], np.int32)))


# (k_step, gt_spec given, speaker mix): from noise at k_step_max, shallow
# from a given mel (the CLI's -ddsp), and with a speaker mix
UNIT2MEL_CASES = ((K_MAX, False, False), (50, True, False), (K_MAX, False, True))


@pytest.mark.parametrize("k_step,with_gt,mix", UNIT2MEL_CASES,
                         ids=("noise", "shallow", "mix"))
def test_unit2mel_mel_matches(unit2mel, k_step, with_gt, mix):
    jm, params, port = unit2mel
    x = _inputs(54)
    gt = x["gt_spec"] if with_gt else None
    spk = _spk(mix)
    want = jm.apply({"params": params}, *map(jnp.asarray, (
        x["units"], x["f0"], x["volume"])),
        spk_id=None if mix else jnp.asarray(spk["spk_id"]),
        spk_mix_dict=spk.get("spk_mix_dict"), aug_shift=jnp.full((1, 1, 1), 2.0),
        gt_spec=None if gt is None else jnp.asarray(gt), infer_speedup=10,
        sampler="dpm-solver", k_step=k_step, init_noise=jnp.asarray(x["init_noise"]),
        key=jax.random.PRNGKey(4))
    with torch.no_grad():
        got = port(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                   spk_id=None if mix else torch.as_tensor(spk["spk_id"]),
                   spk_mix_dict=spk.get("spk_mix_dict"),
                   aug_shift=torch.full((1, 1, 1), 2.0),
                   gt_spec=None if gt is None else tt(gt), infer_speedup=10,
                   sampler="dpm-solver", k_step=k_step,
                   init_noise=tt(x["init_noise"]))
    print(f"unit2mel mel rel err ({k_step}, gt {with_gt}, mix {mix}): "
          f"{rel_err(got, want):.2e}")
    assert got.shape == (1, T, 128)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("mix", [False, True], ids=("spk", "mix"))
def test_unit2wav_mel_matches(unit2wav, mix):
    jm, variables, port = unit2wav
    x = _inputs(55)
    spk = _spk(mix)
    jmel = JLogMel()
    want = jm.apply(variables, *map(jnp.asarray, (x["units"], x["f0"], x["volume"])),
                    spk_id=None if mix else jnp.asarray(spk["spk_id"]),
                    spk_mix_dict=spk.get("spk_mix_dict"),
                    aug_shift=jnp.full((1, 1, 1), -1.0),
                    mel_extract_fn=jmel.extract, infer_speedup=10,
                    sampler="dpm-solver", k_step=K_MAX,
                    ddsp_noise=jnp.asarray(x["ddsp_noise"]),
                    init_noise=jnp.asarray(x["init_noise"]), key=jax.random.PRNGKey(4))
    with torch.no_grad():
        got = port(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                   spk_id=None if mix else torch.as_tensor(spk["spk_id"]),
                   spk_mix_dict=spk.get("spk_mix_dict"),
                   aug_shift=torch.full((1, 1, 1), -1.0),
                   mel_extract_fn=Vocoder().extract, infer_speedup=10,
                   sampler="dpm-solver", k_step=K_MAX,
                   ddsp_noise=tt(x["ddsp_noise"]), init_noise=tt(x["init_noise"]))
    print(f"unit2wav mel rel err (mix {mix}): {rel_err(got, want):.2e}")
    assert got.shape == (1, T, 128)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("keyshift", [-3.0, 0.0, 5.5])
@pytest.mark.parametrize("speed", [1.0, 1.2])
def test_mel_extractor_keyshift_and_speed(keyshift, speed):
    rng = np.random.default_rng(56)
    audio = (0.3 * np.sin(2 * np.pi * 330 * np.arange(9000) / SR)
             + 0.05 * rng.standard_normal(9000)).astype(np.float32)[None]
    want = JLogMel()(jnp.asarray(audio), keyshift=keyshift, speed=speed)
    got = LogMelSpectrogram()(torch.from_numpy(audio), keyshift=keyshift,
                              speed=speed)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


def _generator_case(resblock):
    cfg = dict(upsample_initial_channel=32, resblock=resblock)
    if resblock == "2":
        cfg["resblock_dilation_sizes"] = ((1, 3), (1, 3), (1, 3))
    jg = JGenerator(SR, 128, **{k: v for k, v in cfg.items()})
    params = randomize_tree(jax.eval_shape(lambda: jg.init(
        {"params": KEYS["params"], "noise": KEYS["noise"]},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"]), seed=57)
    return cfg, jg, params


def _sine_noise(seed, n):
    rng = np.random.default_rng(seed)
    return (np.concatenate([[0.0], rng.random(8)]).astype(np.float32)[None, None],
            rng.standard_normal((1, n, 9)).astype(np.float32))


def test_resblock2_generator_matches():
    cfg, jg, params = _generator_case("2")
    assert "convs_0" in params["resblocks_0"]
    rng = np.random.default_rng(58)
    mel = rng.uniform(-8, 0, (1, 12, 128)).astype(np.float32)
    f0 = f0_contour(12)[..., 0]
    ri, sn = _sine_noise(59, 12 * BLOCK)
    want = jg.apply({"params": params}, jnp.asarray(mel), jnp.asarray(f0),
                    sine_kwargs=dict(rand_ini=jnp.asarray(ri), noise=jnp.asarray(sn)))
    voc = Vocoder(config=cfg)
    load_state(voc.model, generator_state_dict(params, n_dilations=2, resblock="2"))
    with torch.no_grad():
        got = voc.infer(tt(mel), tt(f0), dict(rand_ini=tt(ri), noise=tt(sn)))
    assert rel_err(got, want) <= 1e-5


def test_log10_vocoder_matches(monkeypatch):
    cfg, jg, params = _generator_case("1")
    monkeypatch.setattr(jvoc, "DEFAULT_NSF_CONFIG",
                        dict(jvoc.DEFAULT_NSF_CONFIG, **cfg))
    jv = jvoc.Vocoder("nsf-hifigan-log10")
    rng = np.random.default_rng(60)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(12 * BLOCK) / SR)
             + 0.02 * rng.standard_normal(12 * BLOCK)).astype(np.float32)[None]
    f0 = f0_contour(12)  # the mel of 12 blocks has 12 frames
    ri, sn = _sine_noise(61, 12 * BLOCK)
    jv.params = params
    jv._infer = jax.jit(lambda p, mel, f, key: jg.apply(
        {"params": p}, mel, f, sine_kwargs=dict(rand_ini=jnp.asarray(ri),
                                                noise=jnp.asarray(sn))))
    want_mel = jv.extract(jnp.asarray(audio))
    want = jv.infer(want_mel, jnp.asarray(f0))

    voc = Vocoder("nsf-hifigan-log10", cfg)
    load_state(voc.model, generator_state_dict(params))
    with torch.no_grad():
        got_mel = voc.extract(torch.from_numpy(audio))
        got = voc.infer(tt(want_mel), tt(f0), dict(rand_ini=tt(ri), noise=tt(sn)))
    assert rel_err(got_mel, want_mel) <= 1e-5
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("family", ["Diffusion", "DiffusionNew"])
def test_family_audio_matches_jax(request, family):
    """infer_features (dpm-solver at speedup 10 over k_step_max 100, the
    NSF-HiFiGAN, the volume mask) against the JAX cascade's mel through the
    JAX generator with the same sine draws."""
    cfg, jg, voc_params = _generator_case("1")
    x = _inputs(62)
    ri, sn = _sine_noise(63, T * BLOCK)
    mask = np.ones(T, np.float32)
    mask[T // 2: T // 2 + 5] = 0.0
    if family == "Diffusion":
        jm, params, port = request.getfixturevalue("unit2mel")
        variables = {"params": params}
        extra = {}
        model_cfg = dict(n_hidden=N_HIDDEN)
    else:
        jm, variables, port = request.getfixturevalue("unit2wav")
        extra = dict(mel_extract_fn=JLogMel().extract,
                     ddsp_noise=jnp.asarray(x["ddsp_noise"]))
        model_cfg = {}
    mel = jm.apply(variables, *map(jnp.asarray, (x["units"], x["f0"], x["volume"])),
                   spk_id=jnp.asarray([[2]]), infer_speedup=10,
                   sampler="dpm-solver", k_step=K_MAX,
                   init_noise=jnp.asarray(x["init_noise"]),
                   key=jax.random.PRNGKey(4), **extra)
    audio = jg.apply({"params": voc_params}, mel, jnp.asarray(x["f0"][:, :, 0]),
                     sine_kwargs=dict(rand_ini=jnp.asarray(ri), noise=jnp.asarray(sn)))
    m = j_upsample(jnp.asarray(mask)[None, :, None], BLOCK)[..., 0]
    want = np.asarray(audio * m[:, :audio.shape[-1]])

    vocoder = Vocoder(config=cfg)
    load_state(vocoder.model, generator_state_dict(voc_params))
    args = DotDict({"data": {"sampling_rate": SR, "block_size": BLOCK,
                             "encoder_out_channels": N_UNIT},
                    "model": dict(type=family, n_layers=N_LAYERS, n_chans=N_CHANS,
                                  k_step_max=K_MAX, use_pitch_aug=True, n_spk=2,
                                  **model_cfg)})
    pipe = SvcPipeline.from_parts(port, None, args, vocoder, device="cpu")
    noise = dict(ddsp=x["ddsp_noise"], diffusion=x["init_noise"], rand_ini=ri,
                 sine=sn)
    got, sr = pipe.infer_features(x["units"], x["f0"], x["volume"], mask,
                                  spk_id=2, noise=noise)
    got = got.numpy()
    assert sr == SR and got.shape == want.shape == (1, T * BLOCK)
    assert np.all(got[:, T // 2 * BLOCK:(T // 2 + 4) * BLOCK] == 0.0)
    snr = snr_db(want, got)
    print(f"{family} audio SNR vs JAX: {snr:.1f} dB")
    assert snr >= 40.0
