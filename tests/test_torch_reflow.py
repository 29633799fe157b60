"""The rectified-flow family -- ``cascade.ReflowUnit2Wav`` (CombSubSuperFast
-> log-mel -> the Euler or RK4 ODE over a NaiveV2Diff velocity net) and
its slice through ``SvcPipeline.infer_features`` -- against the JAX
package's ``ReflowUnit2Wav`` at small widths (2 layers x 64 channels, T =
40), the same randomised params and the same injected noise.

Tolerances, against the JAX cascade run eagerly (ROADMAP C(h)): the
velocity of each ODE call (the port's net on the JAX call's inputs) 1e-5 x
max|v|; each ODE state fed the JAX velocities, and the mel of the port's
own chain, 1e-5 x max|mel|; the t_start >= 1 and infer_step 0 bypasses
return the DDSP mel, 1e-5; the audio through NSF-HiFiGAN and the volume
mask against the jitted JAX direct path >= 40 dB SNR, the bar
tests/test_torch_slice.py holds DiffusionFast to."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.cascade import ReflowUnit2Wav as JReflow
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops.interp import upsample as j_upsample
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io.jax_params import (generator_state_dict, load_state,
                                              reflow_state_dict)
from ddsp_svc_tpu_torch.models.cascade import ReflowUnit2Wav
from ddsp_svc_tpu_torch.models.reflow import RectifiedFlow
from ddsp_svc_tpu_torch.models.vocoder import Vocoder
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_helpers import f0_contour, randomize_tree, rel_err, snr_db, tt

SR, BLOCK, WIN, N_UNIT, N_LAYERS, T = 44100, 512, 2048, 64, 2, 40
KW = dict(sampling_rate=SR, block_size=BLOCK, win_length=WIN, n_unit=N_UNIT,
          n_spk=2, use_pitch_aug=True, out_dims=128, n_layers=N_LAYERS,
          n_chans=64)
# (sampler, infer_step, t_start): the config's euler 20 at 0.7, rk4 5
CASES = (("euler", 20, 0.7), ("rk4", 5, 0.7))


@pytest.fixture(scope="module")
def reflow():
    jm = JReflow(**KW)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, N_UNIT)), jnp.full((1, 8, 1), 220.0),
        jnp.ones((1, 8, 1)), spk_id=jnp.ones((1, 1), jnp.int32),
        aug_shift=jnp.zeros((1, 1, 1)), mel_extract_fn=JLogMel().extract,
        gt_spec=jnp.zeros((1, 8, 128)), infer=False,
        key=jax.random.PRNGKey(2))["params"])
    params = randomize_tree(shapes, seed=41)
    port = ReflowUnit2Wav(**KW)
    load_state(port, reflow_state_dict(params, N_LAYERS))
    rng = np.random.default_rng(42)
    x = dict(units=rng.standard_normal((1, T, N_UNIT)).astype(np.float32),
             f0=f0_contour(T), volume=rng.uniform(0.05, 0.3, (1, T, 1)).astype(np.float32),
             spk_id=np.array([[2]], np.int32),
             aug_shift=np.full((1, 1, 1), 2.0, np.float32),
             ddsp_noise=rng.standard_normal((1, T * BLOCK)).astype(np.float32),
             init_noise=rng.standard_normal((1, T, 128)).astype(np.float32))
    return jm, params, port.eval(), x


def _jax_run(jm, params, x, sampler, infer_step, t_start):
    """The JAX cascade's mel, its DDSP mel and every velocity call's (x, t,
    v), stacked; run eagerly, since jitted XLA rounds the DDSP stage's phase
    arithmetic up to 5e-4 away (ROADMAP C(h))."""
    jmel = JLogMel()

    def run(p, units, f0, volume, spk, aug, dn, n):
        calls, conds = [], []

        def extract(wav):
            conds.append(jmel.extract(wav))
            return conds[-1]

        def wrapper(v_fn):
            def wrapped(x_, t_):
                v = v_fn(x_, t_)
                calls.append((x_, t_, v))
                return v
            return wrapped

        mel = jm.apply({"params": p}, units, f0, volume, spk_id=spk,
                       aug_shift=aug, mel_extract_fn=extract,
                       infer_step=infer_step, sampler=sampler, t_start=t_start,
                       ddsp_noise=dn, init_noise=n, key=jax.random.PRNGKey(0),
                       velocity_wrapper=wrapper)
        stack = ([jnp.stack([c[i] for c in calls]) for i in range(3)]
                 if calls else [jnp.zeros(0)] * 3)
        return mel, conds[0], *stack

    out = run(params, *map(jnp.asarray, (
        x["units"], x["f0"], x["volume"], x["spk_id"], x["aug_shift"],
        x["ddsp_noise"], x["init_noise"])))
    return [np.asarray(o) for o in out]


def _port_mel(port, x, **kw):
    with torch.no_grad():
        return port(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                    spk_id=torch.as_tensor(x["spk_id"]),
                    aug_shift=tt(x["aug_shift"]), mel_extract_fn=Vocoder().extract,
                    ddsp_noise=tt(x["ddsp_noise"]), init_noise=tt(x["init_noise"]),
                    **kw).numpy()


@pytest.fixture(scope="module")
def jax_runs(reflow):
    jm, params, _, x = reflow
    return {case: _jax_run(jm, params, x, *case) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_each_velocity_call_matches(reflow, jax_runs, case):
    _, _, port, _ = reflow
    _, cond, xs, ts, vs = jax_runs[case]
    sampler, steps, _ = case
    assert xs.shape[0] == steps * (4 if sampler == "rk4" else 1)
    with torch.no_grad():
        for i in range(xs.shape[0]):
            got = port.velocity_fn(tt(xs[i]), 1000.0 * tt(ts[i]), tt(cond))
            assert rel_err(got, vs[i]) <= 1e-5, i


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_each_ode_step_matches(reflow, jax_runs, case):
    """The port's ODE fed the JAX velocities: each call's state and time
    (the host-float t filled as f32) and the final mel."""
    mel, cond, xs, ts, vs = jax_runs[case]
    _, _, _, x = reflow
    sampler, steps, t_start = case
    seen = []

    def teacher(x_, t_):
        i = len(seen)
        seen.append(x_)
        np.testing.assert_array_equal(t_.numpy(), np.float32(1000.0) * ts[i])
        return tt(vs[i])

    got = RectifiedFlow().infer(teacher, tt(cond), steps, sampler, t_start,
                                init_noise=tt(x["init_noise"]))
    assert len(seen) == xs.shape[0]
    for i, s in enumerate(seen):
        assert rel_err(s, xs[i]) <= 1e-5, i
    assert rel_err(got, mel) <= 1e-5


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_cascade_mel_matches(reflow, jax_runs, case):
    _, _, port, x = reflow
    mel, cond = jax_runs[case][:2]
    sampler, steps, t_start = case
    got = _port_mel(port, x, infer_step=steps, sampler=sampler, t_start=t_start)
    print(f"reflow {sampler} mel rel err vs JAX: {rel_err(got, mel):.2e}")
    assert got.shape == mel.shape == (1, T, 128)
    assert rel_err(got, mel) <= 1e-5


@pytest.mark.parametrize("infer_step,t_start", [(20, 1.0), (20, 1.5), (0, 0.7)])
def test_bypass_returns_the_ddsp_mel(reflow, jax_runs, infer_step, t_start):
    """t_start >= 1 or infer_step 0: no velocity call, the DDSP mel."""
    jm, params, port, x = reflow
    want_mel, cond, xs = _jax_run(jm, params, x, "euler", infer_step, t_start)[:3]
    assert xs.size == 0
    np.testing.assert_array_equal(want_mel, cond)
    calls = []
    hook = port.velocity_fn.register_forward_hook(lambda *a: calls.append(1))
    try:
        got = _port_mel(port, x, infer_step=infer_step, sampler="euler",
                        t_start=t_start)
    finally:
        hook.remove()
    assert not calls
    assert rel_err(got, cond) <= 1e-5


def test_reflow_slice_audio_matches_jax(reflow):
    """infer_features with the pipeline's defaults (euler, 20 steps, the
    config's t_start 0.7; no formant shift), NSF-HiFiGAN and the volume
    mask, against the JAX cascade's mel through the JAX generator with the
    same sine draws."""
    jm, params, port, x = reflow
    jg = JGenerator(sampling_rate=SR, num_mels=128, upsample_initial_channel=32)
    voc_params = randomize_tree(jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"]), seed=43)
    rng = np.random.default_rng(44)
    mask = np.ones(T, np.float32)
    mask[T // 2: T // 2 + 5] = 0.0
    noise = dict(ddsp=x["ddsp_noise"], diffusion=x["init_noise"],
                 rand_ini=np.concatenate([[0.0], rng.random(8)]).astype(
                     np.float32)[None, None],
                 sine=rng.standard_normal((1, T * BLOCK, 9)).astype(np.float32))

    def jax_direct(p, vp, u, f, v, s, dn, n, ri, sn, mk):
        mel = jm.apply({"params": p}, u, f, v, spk_id=s,
                       mel_extract_fn=JLogMel().extract, infer_step=20,
                       sampler="euler", t_start=0.7, ddsp_noise=dn,
                       init_noise=n, key=jax.random.PRNGKey(0))
        audio = jg.apply({"params": vp}, mel, f[:, :mel.shape[1], 0],
                         sine_kwargs=dict(rand_ini=ri, noise=sn))
        m = j_upsample(mk[None, :, None], BLOCK)[..., 0]
        return audio * m[:, :audio.shape[-1]]

    want = np.asarray(jax.jit(jax_direct)(params, voc_params, *map(jnp.asarray, (
        x["units"], x["f0"], x["volume"], x["spk_id"], noise["ddsp"],
        noise["diffusion"], noise["rand_ini"], noise["sine"], mask))))

    vocoder = Vocoder(config={"upsample_initial_channel": 32})
    load_state(vocoder.model, generator_state_dict(voc_params))
    args = DotDict({"data": {"sampling_rate": SR, "block_size": BLOCK,
                             "encoder_out_channels": N_UNIT},
                    "model": dict(type="RectifiedFlow", win_length=WIN,
                                  n_layers=N_LAYERS, n_chans=64, t_start=0.7,
                                  use_pitch_aug=True, n_spk=2)})
    pipe = SvcPipeline.from_parts(port, None, args, vocoder, device="cpu")
    assert pipe.sampler_kwargs() == dict(infer_step=20, sampler="euler",
                                         t_start=0.7)
    got, sr = pipe.infer_features(x["units"], x["f0"], x["volume"], mask,
                                  spk_id=2, noise=noise)
    got = got.numpy()
    assert sr == SR and got.shape == want.shape == (1, T * BLOCK)
    assert np.all(got[:, T // 2 * BLOCK:(T // 2 + 4) * BLOCK] == 0.0)
    snr = snr_db(want, got)
    print(f"reflow slice audio SNR vs JAX: {snr:.1f} dB")
    assert snr >= 40.0
