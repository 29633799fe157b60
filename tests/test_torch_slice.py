"""The whole serving slice -- SvcPipeline.infer_features: DiffusionFast
cascade, NSF-HiFiGAN, volume mask -- against the JAX direct path
(ddsp_svc_tpu/infer/pipeline.py, the jitted ``fwd`` with silence_front 0),
same model, params, noise and mask, at small widths, k_step 100, speedup 10.

At random init a chain-level number alone cannot tell a fault from the
chain's own sensitivity, so the binding checks are per denoiser call (the
port's denoiser on the JAX call's inputs) and per sampler step (the port's
sampler fed the JAX denoiser outputs); the chain's audio SNR is reported
and must reach 40 dB."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops.interp import upsample as j_upsample
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io.jax_params import generator_state_dict, load_state
from ddsp_svc_tpu_torch.models.diffusion import linear_schedule, sample_dpmpp_2m
from ddsp_svc_tpu_torch.models.vocoder import Vocoder
from ddsp_svc_tpu_torch.utils.config import DotDict
from test_torch_models import BLOCK, K_MAX, N_LAYERS, N_UNIT, SR, T, build_cascade
from torch_helpers import randomize_tree, rel_err, snr_db, tt

VOC = dict(sampling_rate=SR, num_mels=128, upsample_initial_channel=32)


@pytest.fixture(scope="module")
def slice_run():
    jm, params, port_model, x = build_cascade()
    jg = JGenerator(**VOC)
    voc_params = randomize_tree(jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"]), seed=11)
    rng = np.random.default_rng(12)
    frame_mask = np.ones(T, np.float32)
    frame_mask[T // 2: T // 2 + 5] = 0.0
    noise = dict(ddsp=x["ddsp_noise"], diffusion=x["init_noise"],
                 rand_ini=np.concatenate([[0.0], rng.random(8)]).astype(
                     np.float32)[None, None],
                 sine=rng.standard_normal((1, T * BLOCK, 9)).astype(np.float32))
    jmel = JLogMel()

    def jax_direct(p, vp, units, f0, volume, mask, dn, n, ri, sn):
        calls, conds = [], []

        def extract(wav):
            conds.append(jmel.extract(wav))
            return conds[-1]

        def wrapper(eps_fn):
            def wrapped(x_, t_):
                e = eps_fn(x_, t_)
                calls.append((x_, t_, e))
                return e
            return wrapped

        mel = jm.apply({"params": p}, units, f0, volume,
                       spk_id=jnp.asarray(x["spk_id"]), mel_extract_fn=extract,
                       k_step=K_MAX, infer_speedup=10, sampler="dpm-solver",
                       ddsp_noise=dn, init_noise=n, key=jax.random.PRNGKey(0),
                       denoise_wrapper=wrapper)
        audio = jg.apply({"params": vp}, mel, f0[:, :mel.shape[1], 0],
                         sine_kwargs=dict(rand_ini=ri, noise=sn))
        m = j_upsample(mask[None, :, None], BLOCK)[..., 0]
        stack = [jnp.stack([c[i] for c in calls]) for i in range(3)]
        return audio * m[:, :audio.shape[-1]], mel, conds[0], *stack

    want = jax.jit(jax_direct)(params, voc_params, *map(jnp.asarray, (
        x["units"], x["f0"], x["volume"], frame_mask, noise["ddsp"],
        noise["diffusion"], noise["rand_ini"], noise["sine"])))
    want = [np.asarray(w) for w in want]

    vocoder = Vocoder(config={"upsample_initial_channel": 32})
    load_state(vocoder.model, generator_state_dict(voc_params))
    args = DotDict({
        "data": {"sampling_rate": SR, "block_size": BLOCK,
                 "encoder_out_channels": N_UNIT},
        "model": {"type": "DiffusionFast", "win_length": 2048,
                  "n_layers": N_LAYERS, "n_chans": 64, "k_step_max": K_MAX,
                  "use_pitch_aug": True, "n_spk": 2}})
    pipe = SvcPipeline.from_parts(port_model, None, args, vocoder, device="cpu")
    got, sr = pipe.infer_features(x["units"], x["f0"], x["volume"], frame_mask,
                                  spk_id=2, k_step=K_MAX, speedup=10,
                                  method="dpm-solver", noise=noise)
    return dict(want=want, got=got.numpy(), sr=sr, pipe=pipe, noise=noise, x=x)


def test_each_denoiser_call_matches(slice_run):
    """The port's denoiser on each JAX call's (x, t, cond): 1e-4 relative."""
    _, _, cond, xs, ts, eps = slice_run["want"]
    denoise = slice_run["pipe"].model.denoise_fn
    assert xs.shape[0] == 10  # k_step 100 // speedup 10 calls
    with torch.no_grad():
        for i in range(xs.shape[0]):
            got = denoise(tt(xs[i]), tt(ts[i]), tt(cond))
            assert rel_err(got, eps[i]) <= 1e-4, i


def test_each_sampler_step_matches(slice_run):
    """The port's q_sample and DPM-Solver++ steps fed the JAX denoiser
    outputs: each step's state to 1e-5 relative, and the mel."""
    _, mel, cond, xs, ts, eps = slice_run["want"]
    diff = slice_run["pipe"].model.diff_model
    x0 = diff.q_sample(diff.norm_spec(tt(cond)), K_MAX - 1,
                       tt(slice_run["noise"]["diffusion"]))
    seen = []

    def teacher(x_, t_):
        i = len(seen)
        seen.append(x_)
        np.testing.assert_allclose(t_.numpy(), ts[i], rtol=1e-6)
        return tt(eps[i])

    out = sample_dpmpp_2m(x0, teacher, linear_schedule()["betas"], K_MAX, 10)
    for i, s in enumerate(seen):
        assert rel_err(s, xs[i]) <= 1e-5, i
    assert rel_err(diff.denorm_spec(out), mel) <= 1e-5


def test_slice_audio_matches_jax_direct_path(slice_run):
    want_audio = slice_run["want"][0]
    got = slice_run["got"]
    assert slice_run["sr"] == SR
    assert got.shape == want_audio.shape == (1, T * BLOCK)
    assert np.isfinite(got).all()
    masked = slice(T // 2 * BLOCK, (T // 2 + 4) * BLOCK)  # mask 0 to 0
    assert np.all(got[:, masked] == 0.0)  # the volume mask applies
    snr = snr_db(want_audio, got)
    print(f"slice audio SNR vs the JAX direct path: {snr:.1f} dB")
    assert snr >= 40.0


@pytest.mark.parametrize("method,speedup", [("ddim", 10), ("pndm", 10),
                                            ("unipc", 10), ("dpm-solver", 1)])
def test_every_sampler_runs_in_the_pipeline(slice_run, method, speedup):
    """Every sampler the JAX cascade accepts (each held step by step in
    tests/test_torch_samplers.py) through ``infer_features``, speedup 1
    being the full DDPM chain: finite audio of the request's length, the
    volume mask applied. An unknown method raises."""
    x = slice_run["x"]
    frame_mask = np.ones(T, np.float32)
    frame_mask[T // 2: T // 2 + 5] = 0.0
    audio, sr = slice_run["pipe"].infer_features(
        x["units"], x["f0"], x["volume"], frame_mask, spk_id=2, k_step=K_MAX,
        speedup=speedup, method=method)
    got = audio.numpy()
    assert sr == SR and got.shape == (1, T * BLOCK) and np.isfinite(got).all()
    assert np.all(got[:, T // 2 * BLOCK:(T // 2 + 4) * BLOCK] == 0.0)
    assert np.abs(got).max() > 0.0
    with pytest.raises(NotImplementedError):
        slice_run["pipe"].infer_features(x["units"], x["f0"], x["volume"],
                                         frame_mask, method="euler")
