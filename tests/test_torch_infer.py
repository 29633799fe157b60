"""``SvcPipeline.infer`` -- a recording in, the converted recording out --
against the JAX package's ``SvcPipeline.infer`` (its direct path: the
units encoder fused into the jitted forward) at small widths: the tiny
encoder, a 2-layer DiffusionFast trunk with a 32-channel NSF-HiFiGAN, and
Sins with the same NSF-HiFiGAN as its enhancer. Both sides get the same
randomised params and the same noise: the JAX models' ``ddsp_noise`` /
``init_noise`` / ``noise`` / ``sine_kwargs`` hooks are reached by wrapping
their ``apply``.

The front end (units, f0 with the key shift, volume, mask) is held to the
JAX calls themselves: f0, volume and mask exactly, units within 1e-5 x
max|out|; the whole conversion to an audio SNR >= 40 dB in
tests/test_torch_infer_diffusion.py and tests/test_torch_infer_ddsp.py,
which share these fixtures and wrappers."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.models.vocoder as jvoc
from ddsp_svc_tpu.features import hubert as jh
from ddsp_svc_tpu.features.f0 import F0Extractor as JF0Extractor
from ddsp_svc_tpu.features.volume import VolumeExtractor as JVolume
from ddsp_svc_tpu.infer.pipeline import SvcPipeline as JPipeline
from ddsp_svc_tpu.models.cascade import Unit2WavFast as JUnit2WavFast
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu.utils.config import DotDict as JDotDict
from ddsp_svc_tpu_torch.features import hubert as ph
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io.jax_params import (generator_state_dict, load_state,
                                              unit2wav_fast_state_dict)
from ddsp_svc_tpu_torch.models.cascade import Unit2WavFast
from ddsp_svc_tpu_torch.models.vocoder import Vocoder
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_helpers import randomize_tree, rel_err

SR, BLOCK, WIN, N_UNIT, N_SPK, K_MAX = 44100, 512, 2048, 256, 2, 100
VOC_CFG = dict(upsample_initial_channel=32)
SECONDS = 0.5


def voice(sample_rate=SR, seconds=SECONDS, seed=0):
    """A vibrato tone with noise and a 0.2 s hole (below -60 dB) in it."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sample_rate * seconds)) / sample_rate
    f = 230.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    a = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / sample_rate)
    a = a + 0.01 * rng.standard_normal(len(t))
    a[int(0.3 * len(a)):int(0.3 * len(a)) + sample_rate // 5] = 0.0
    return a.astype(np.float32)


class Noisy:
    """A JAX module whose ``apply`` always gets ``extra`` keyword arguments
    (the injected noise) and ``variables`` (the PCmer buffers)."""

    def __init__(self, module, variables=None, **extra):
        self.module, self.variables, self.extra = module, variables or {}, extra

    def apply(self, variables, *args, **kwargs):
        return self.module.apply({**variables, **self.variables}, *args,
                                 **kwargs, **self.extra)


class NoisyVocoder:
    """The JAX NSF-HiFiGAN generator with its sine draws injected."""

    def __init__(self, generator, noise):
        self.generator, self.noise = generator, noise

    def apply(self, variables, mel, f0, key=None):
        n = mel.shape[1] * BLOCK
        return self.generator.apply(variables, mel, f0, sine_kwargs=dict(
            rand_ini=jnp.asarray(self.noise["rand_ini"]),
            noise=jnp.asarray(self.noise["sine"][:, :n])))


@pytest.fixture(scope="module")
def encoders():
    """(JAX tiny UnitsEncoder, the port's with the same weights)."""
    variables = {"params": randomize_tree(
        jh.UnitsEncoder("tiny").variables["params"], seed=21)}
    return (jh.UnitsEncoder("tiny", params=variables),
            ph.UnitsEncoder("tiny", params=variables, device="cpu"))


@pytest.fixture(scope="module")
def nsf():
    """(NSF-HiFiGAN params, the port's Vocoder with them)."""
    shapes = jax.eval_shape(lambda: JGenerator(SR, 128, **VOC_CFG).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"])
    params = randomize_tree(shapes, seed=22)
    vocoder = Vocoder(config=VOC_CFG)
    load_state(vocoder.model, generator_state_dict(params))
    return params, vocoder


def _noise(t_run, n_samples, ddsp_uniform=False, seed=23):
    rng = np.random.default_rng(seed)
    noise = {"diffusion": rng.standard_normal((1, t_run, 128)),
             "ddsp": (rng.uniform(-1, 1, (1, t_run * BLOCK)) if ddsp_uniform
                      else rng.standard_normal((1, t_run * BLOCK))),
             "rand_ini": np.concatenate([[0.0], rng.random(8)])[None, None],
             "sine": rng.standard_normal((1, n_samples, 9))}
    return {k: v.astype(np.float32) for k, v in noise.items()}


def _jax_pipeline(monkeypatch, model, params, args, jenc, nsf_params, noise,
                  enhance=False):
    monkeypatch.setattr(jvoc, "DEFAULT_NSF_CONFIG",
                        dict(jvoc.DEFAULT_NSF_CONFIG, **VOC_CFG))
    pipe = JPipeline.from_parts(model, {"params": params}, JDotDict(args), jenc,
                                enhance=enhance)
    generator = NoisyVocoder(JGenerator(SR, 128, **VOC_CFG), noise)
    for voc in (pipe.vocoder, pipe.enhancer and pipe.enhancer.vocoder):
        if voc is not None:
            voc.params = nsf_params
            voc.model = generator
            if enhance:
                monkeypatch.setattr(voc, "infer", lambda mel, f0, key=None: (
                    jax.jit(generator.apply)({"params": nsf_params}, mel,
                                             f0[:, :mel.shape[1]])))
    return pipe


def _diffusion_args():
    return {"data": {"sampling_rate": SR, "block_size": BLOCK,
                     "encoder_out_channels": N_UNIT},
            "model": {"type": "DiffusionFast", "win_length": WIN, "n_layers": 2,
                      "n_chans": 64, "k_step_max": K_MAX, "n_spk": N_SPK},
            "vocoder": {"type": "nsf-hifigan", "ckpt": None},
            "enhancer": None}


@pytest.fixture(scope="module")
def cascade():
    """(JAX Unit2WavFast, its params, the port's with the same weights)."""
    kw = dict(sampling_rate=SR, block_size=BLOCK, win_length=WIN,
              n_unit=N_UNIT, n_spk=N_SPK, out_dims=128, n_layers=2, n_chans=64)
    jm = JUnit2WavFast(**kw, k_step_max=K_MAX)
    t = 8
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, N_UNIT)), jnp.full((1, t, 1), 220.0),
        jnp.ones((1, t, 1)), spk_id=jnp.ones((1, 1), jnp.int32),
        mel_extract_fn=JLogMel().extract, gt_spec=jnp.zeros((1, t, 128)),
        infer=False, key=jax.random.PRNGKey(2))["params"])
    params = randomize_tree(shapes, seed=24)
    port = Unit2WavFast(**kw)
    load_state(port, unit2wav_fast_state_dict(params, 2))
    return jm, params, port.eval()


@pytest.mark.parametrize("sample_rate,key_shift,silence_front,device_f0", [
    (SR, 0.0, 0.0, False), (32000, 2.0, 0.1, False), (SR, -3.0, 0.1, True)])
def test_front_end_matches_jax(encoders, cascade, nsf, sample_rate, key_shift,
                               silence_front, device_f0):
    """Units, f0 (key-shifted in f32), volume and frame mask as the JAX
    front-end calls give them, at the model's rate and at 32 kHz (hop
    int(512 * 32000 / 44100) = 371); the device YIN within 0.05 cents."""
    jenc, penc = encoders
    pipe = SvcPipeline.from_parts(cascade[2], None, DotDict(_diffusion_args()),
                                  nsf[1], device="cpu", units_encoder=penc,
                                  device_f0=device_f0)
    a = voice(sample_rate)
    hop = int(BLOCK * sample_rate / SR)
    fe = pipe.front_end(a, sample_rate, key_shift, -60.0, silence_front)

    units = np.asarray(jenc.encode(jnp.asarray(a[None]), sample_rate, hop))
    t = units.shape[1]
    f0 = JF0Extractor("yin", sample_rate, hop, 50.0, 1100.0).extract(
        a, uv_interp=True, silence_front=silence_front)
    f0 = (f0[None, :, None] * np.float32(2 ** (key_shift / 12.0)))[:, :t]
    vx = JVolume(hop)
    volume = vx.extract(a)
    mask = vx.get_mask(volume, -60.0)

    assert fe["units"].shape == (1, len(a) // hop + 1, N_UNIT) == units.shape
    assert rel_err(fe["units"], units) <= 1e-5
    if device_f0:
        got = fe["f0"].numpy()
        assert got.shape == f0.shape
        assert np.abs(1200 * np.log2(got / f0)).max() < 0.05
    else:
        np.testing.assert_array_equal(fe["f0"], f0)
    np.testing.assert_array_equal(fe["volume"], volume[None, :t, None])
    np.testing.assert_array_equal(fe["frame_mask"], mask)
    assert mask.min() == 0.0 and mask.max() == 1.0


def test_infer_refuses_what_is_not_ported(cascade, nsf, encoders):
    """What infer refuses: no units encoder, an unknown sampler for the
    family, an encoder on another device. The speaker mix is ported: a
    {id: weight} dict gives the weighted speaker's conversion (a one-hot
    mix equals that speaker's id)."""
    args = DotDict(_diffusion_args())
    bare = SvcPipeline.from_parts(cascade[2], None, args, nsf[1], device="cpu")
    with pytest.raises(ValueError, match="no units encoder"):
        bare.infer(voice(), SR)
    pipe = SvcPipeline.from_parts(cascade[2], None, args, nsf[1], device="cpu",
                                  units_encoder=encoders[1])
    noise = _noise(len(voice()) // BLOCK + 1, len(voice()) // BLOCK * BLOCK + BLOCK)
    one_hot, _ = pipe.infer(voice(), SR, spk_mix_dict={2: 1.0}, noise=noise)
    by_id, _ = pipe.infer(voice(), SR, spk_id=2, noise=noise)
    np.testing.assert_array_equal(one_hot, by_id)
    mixed, _ = pipe.infer(voice(), SR, spk_mix_dict={1: 0.5, 2: 0.5}, noise=noise)
    assert np.isfinite(mixed).all() and not np.array_equal(mixed, by_id)
    with pytest.raises(NotImplementedError):
        pipe.infer(voice(), SR, method="euler")
    with pytest.raises(ValueError, match="encoder is on"):
        SvcPipeline.from_parts(cascade[2], None, args, nsf[1], device="meta",
                               units_encoder=encoders[1])
