"""``SvcPipeline.infer`` for Sins with its NSF-HiFiGAN enhancer against the
JAX package's ``SvcPipeline.infer`` from the same recording, params, PCmer
buffers and noise (the fixtures and wrappers of tests/test_torch_infer.py):
the audio SNR >= 40 dB with ``silence_front`` 0 and > 0."""
import jax
import jax.numpy as jnp
import pytest

from ddsp_svc_tpu.models import ddsp as jddsp
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io.jax_params import ddsp_state_dict, load_state
from ddsp_svc_tpu_torch.models import ddsp
from ddsp_svc_tpu_torch.utils.config import DotDict
from test_torch_ddsp_models import WIDTHS, jax_variables
from test_torch_infer import (BLOCK, N_SPK, N_UNIT, SR, Noisy,  # noqa: F401
                              _jax_pipeline, _noise, encoders, nsf, voice)
from torch_helpers import snr_db


@pytest.mark.parametrize("silence_front", [0.0, 0.1])
def test_ddsp_infer_with_enhancer_matches_jax(monkeypatch, encoders, nsf,
                                              silence_front):
    jenc, penc = encoders
    w = WIDTHS["Sins"]
    jm = jddsp.Sins(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, **w)
    t = 8
    params, buffers = jax_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, N_UNIT)), jnp.full((1, t, 1), 220.0),
        jnp.ones((1, t, 1)), spk_id=jnp.ones((1, 1), jnp.int32)), seed=25)
    pm = ddsp.Sins(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, **w)
    load_state(pm, ddsp_state_dict(params, buffers))
    args = {"data": {"sampling_rate": SR, "block_size": BLOCK,
                     "encoder_out_channels": N_UNIT},
            "model": dict(type="Sins", n_spk=N_SPK, **w),
            "enhancer": {"type": "nsf-hifigan", "ckpt": "absent.msgpack"}}
    a = voice(seed=2)
    t = len(a) // BLOCK + 1
    noise = _noise(t, 2 * t * BLOCK, ddsp_uniform=True)
    jmodel = Noisy(jm, {"buffers": buffers}, noise=jnp.asarray(noise["ddsp"]))
    jpipe = _jax_pipeline(monkeypatch, jmodel, params, args, jenc, nsf[0], noise,
                          enhance=True)
    kw = dict(spk_id=2, key_shift=-2.0, silence_front=silence_front)
    want, want_sr = jpipe.infer(a, SR, **kw)

    pipe = SvcPipeline.from_parts(pm, None, DotDict(args), nsf[1], device="cpu",
                                  enhance=True, units_encoder=penc)
    got, sr = pipe.infer(a, SR, noise=noise, **kw)
    assert sr == want_sr == SR and got.shape == want.shape == (t * BLOCK,)
    snr = snr_db(want, got)
    print(f"Sins + enhancer infer SNR vs JAX (silence_front {silence_front}): "
          f"{snr:.1f} dB")
    assert snr >= 40.0
