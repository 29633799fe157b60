"""The port's models against the JAX package's at small widths (2-layer
64-channel trunk; vocoder with upsample_initial_channel 32): the same
randomised params (every leaf re-drawn, so no projection is zero), loaded
into the port through io/jax_params, and the same inputs and noise, made
with numpy. The JAX side runs jitted on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.cascade import Unit2WavFast as JUnit2WavFast
from ddsp_svc_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu_torch.io.jax_params import (generator_state_dict, load_state,
                                              unit2wav_fast_state_dict)
from ddsp_svc_tpu_torch.models.cascade import Unit2WavFast
from ddsp_svc_tpu_torch.models.diffusion import linear_schedule, sample_dpmpp_2m
from ddsp_svc_tpu_torch.models.nsf_hifigan import Generator
from ddsp_svc_tpu_torch.ops.mel import LogMelSpectrogram
from torch_helpers import f0_contour, randomize_tree, rel_err, snr_db, tt

SR, BLOCK, WIN = 44100, 512, 2048
N_UNIT, N_SPK, N_LAYERS, N_CHANS, K_MAX = 64, 2, 2, 64, 100
T = 24


def _cascade_kwargs():
    """The port's Unit2WavFast arguments (JAX's take k_step_max too)."""
    return dict(sampling_rate=SR, block_size=BLOCK, win_length=WIN,
                n_unit=N_UNIT, n_spk=N_SPK, use_pitch_aug=True, out_dims=128,
                n_layers=N_LAYERS, n_chans=N_CHANS)


def build_cascade():
    """(JAX module, JAX params, port module, inputs) with aug_shift and a
    second speaker, so every optional embedding exists. The param shapes
    come from ``jax.eval_shape`` of the init: every leaf is drawn anew."""
    jm = JUnit2WavFast(**_cascade_kwargs(), k_step_max=K_MAX)
    rng = np.random.default_rng(0)
    inputs = dict(
        units=rng.standard_normal((1, T, N_UNIT)).astype(np.float32),
        f0=f0_contour(T),
        volume=rng.uniform(0.0, 0.3, (1, T, 1)).astype(np.float32),
        spk_id=np.array([[2]], np.int32),
        aug_shift=np.array([[[1.5]]], np.float32),
        ddsp_noise=rng.standard_normal((1, T * BLOCK)).astype(np.float32),
        init_noise=rng.standard_normal((1, T, 128)).astype(np.float32),
    )
    jmel = JLogMel()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(inputs["units"]), jnp.asarray(inputs["f0"]),
        jnp.asarray(inputs["volume"]), spk_id=jnp.asarray(inputs["spk_id"]),
        aug_shift=jnp.asarray(inputs["aug_shift"]), mel_extract_fn=jmel.extract,
        gt_spec=jnp.zeros((1, T, 128)), infer=False,
        key=jax.random.PRNGKey(2))["params"])
    params = randomize_tree(shapes, seed=1)
    port = Unit2WavFast(**_cascade_kwargs())
    load_state(port, unit2wav_fast_state_dict(params, N_LAYERS))
    return jm, params, port.eval(), inputs


@pytest.fixture(scope="module")
def cascade():
    return build_cascade()


def test_unit2control_matches(cascade):
    from ddsp_svc_tpu.models.unit2control import Unit2Control as JUnit2Control

    jm, params, port, x = cascade
    n_bins = WIN // 2 + 1
    splits = {k: n_bins for k in ("harmonic_magnitude", "harmonic_phase",
                                  "noise_magnitude", "noise_phase")}
    ju = JUnit2Control(N_UNIT, N_SPK, splits, use_pitch_aug=True, use_naive_v2=True)
    phase = np.random.default_rng(3).uniform(-np.pi, np.pi, (1, T, 1)).astype(np.float32)
    args = [x["units"], x["f0"], phase, x["volume"]]
    want_c, want_h = jax.jit(lambda p, *a: ju.apply(
        {"params": p}, *a, spk_id=jnp.asarray(x["spk_id"]),
        aug_shift=jnp.asarray(x["aug_shift"])))(
        params["ddsp_model"]["unit2ctrl"], *map(jnp.asarray, args))
    with torch.no_grad():
        got_c, got_h = port.ddsp_model.unit2ctrl(
            *map(tt, args), spk_id=torch.tensor([[2]]), aug_shift=tt(x["aug_shift"]))
    assert rel_err(got_h, want_h) <= 1e-5
    for k in splits:
        assert rel_err(got_c[k], want_c[k]) <= 1e-5, k


def test_combsub_superfast_matches(cascade):
    """The FFT path: 1e-4 relative to the peak against JAX run op by op.
    Jitted, XLA rounds the combtooth's phase ramp differently (up to ~5e-4
    of the exciter, tests/test_torch_kernels_plain.py), which the STFT
    filter carries into the signal: 2e-3 against the jitted model."""
    from ddsp_svc_tpu.models.ddsp import CombSubSuperFast as JCombSub

    jm, params, port, x = cascade
    jc = JCombSub(SR, BLOCK, WIN, N_UNIT, N_SPK, use_pitch_aug=True)

    def fwd(p, u, f, v, n):
        return jc.apply({"params": p}, u, f, v, spk_id=jnp.asarray(x["spk_id"]),
                        noise=n)[0]

    args = (params["ddsp_model"], *(jnp.asarray(x[k]) for k in
                                    ("units", "f0", "volume", "ddsp_noise")))
    with torch.no_grad():
        got, _ = port.ddsp_model(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                                 spk_id=torch.tensor([[2]]), noise=tt(x["ddsp_noise"]))
    eager = fwd(*args)
    assert got.shape == eager.shape
    assert rel_err(got, eager) <= 1e-4
    assert rel_err(got, jax.jit(fwd)(*args)) <= 2e-3


def test_naive_v2_diff_one_call_matches(cascade):
    """One denoiser call: 1e-4 relative to the peak."""
    from ddsp_svc_tpu.models.naive_v2_diff import NaiveV2Diff as JNaive

    jm, params, port, _ = cascade
    rng = np.random.default_rng(4)
    spec = rng.standard_normal((2, T, 128)).astype(np.float32)
    cond = rng.standard_normal((2, T, 128)).astype(np.float32)
    steps = np.array([99.0, 37.5], np.float32)
    jn = JNaive(mel_channels=128, dim=N_CHANS, use_mlp=False, condition_dim=128,
                num_layers=N_LAYERS)
    want = jax.jit(lambda p, *a: jn.apply({"params": p}, *a))(
        params["denoise_fn"], jnp.asarray(spec), jnp.asarray(steps), jnp.asarray(cond))
    with torch.no_grad():
        got = port.denoise_fn(tt(spec), tt(steps), tt(cond))
    assert float(np.abs(np.asarray(want)).max()) > 1e-3  # the projection is live
    assert rel_err(got, want) <= 1e-4


def test_dpmpp_2m_each_step_matches():
    """The sampler's arithmetic step by step, under one deterministic eps
    function on both sides: every denoiser input (the state after each
    step) and the result to 1e-5 relative."""
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((1, 8, 16)).astype(np.float32)

    def eps_j(x, t):
        return jnp.tanh(0.3 * x + 0.01 * t[:, None, None]) * 0.8

    def eps_t(x, t):
        return torch.tanh(0.3 * x + 0.01 * t[:, None, None]) * 0.8

    def run_jax(x):
        seen = []

        def rec(x_, t_):
            seen.append(x_)
            return eps_j(x_, t_)

        out = JGaussianDiffusion(None, k_step=K_MAX)._sample_dpmpp_2m(x, rec, K_MAX, 10)
        return out, jnp.stack(seen)

    want, want_seen = jax.jit(run_jax)(jnp.asarray(x0))
    seen = []

    def rec_t(x_, t_):
        seen.append(x_)
        return eps_t(x_, t_)

    got = sample_dpmpp_2m(tt(x0), rec_t, linear_schedule()["betas"], K_MAX, 10)
    assert len(seen) == want_seen.shape[0] == 10
    for i, s in enumerate(seen):
        assert rel_err(s, want_seen[i]) <= 1e-5, i
    assert rel_err(got, want) <= 1e-5


def test_unit2wav_fast_matches(cascade):
    """The whole cascade (DDSP -> mel -> 10 DPM-Solver++ steps) with
    injected noise against the jitted JAX model: 5e-4 relative to the peak
    mel. The DDSP mel carries the jitted combtooth's different rounding
    (see test_combsub_superfast_matches; measured 1.1e-4 here); each
    denoiser call and step is held tighter in tests/test_torch_slice.py."""
    jm, params, port, x = cascade
    jmel, mel = JLogMel(), LogMelSpectrogram()
    want = jax.jit(lambda p, u, f, v, dn, n: jm.apply(
        {"params": p}, u, f, v, spk_id=jnp.asarray(x["spk_id"]),
        mel_extract_fn=jmel.extract, k_step=K_MAX, infer_speedup=10,
        sampler="dpm-solver", ddsp_noise=dn, init_noise=n,
        key=jax.random.PRNGKey(0)))(
        params, *(jnp.asarray(x[k]) for k in
                  ("units", "f0", "volume", "ddsp_noise", "init_noise")))
    with torch.no_grad():
        got = port(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                   spk_id=torch.tensor([[2]]), mel_extract_fn=mel.extract,
                   k_step=K_MAX, infer_speedup=10, sampler="dpm-solver",
                   ddsp_noise=tt(x["ddsp_noise"]), init_noise=tt(x["init_noise"]))
    assert got.shape == (1, T, 128)
    assert rel_err(got, want) <= 5e-4


def test_generator_matches():
    """NSF-HiFiGAN with injected sine noise, including the transposed convs
    with padding (k - u) // 2: rtol 1e-4 / atol 1e-5 (the JAX fused
    generator test's bound) and >= 60 dB SNR."""
    cfg = dict(sampling_rate=SR, num_mels=128, upsample_initial_channel=32)
    jg = JGenerator(**cfg)
    t = 6
    rng = np.random.default_rng(6)
    mel = rng.normal(-4.0, 1.5, (1, t, 128)).astype(np.float32)
    f0 = f0_contour(t)[..., 0]
    rand_ini = np.concatenate([[0.0], rng.random(8)]).astype(np.float32)[None, None]
    noise = rng.standard_normal((1, t * 512, 9)).astype(np.float32)
    params = randomize_tree(jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0))["params"]), seed=7)
    want = jax.jit(lambda p, m, f, r, n: jg.apply(
        {"params": p}, m, f, sine_kwargs=dict(rand_ini=r, noise=n)))(
        params, *map(jnp.asarray, (mel, f0, rand_ini, noise)))
    port = Generator(**cfg)
    load_state(port, generator_state_dict(params))
    with torch.no_grad():
        got = port(tt(mel), tt(f0), dict(rand_ini=tt(rand_ini), noise=tt(noise)))
    assert got.shape == (1, t * 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert snr_db(want, got) >= 60.0
