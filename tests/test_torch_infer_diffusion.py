"""``SvcPipeline.infer`` for DiffusionFast against the JAX package's
``SvcPipeline.infer`` from the same recording, params and noise (the
fixtures and wrappers of tests/test_torch_infer.py): the audio SNR >= 40 dB
with ``silence_front`` 0, with a silent prefix left out of the vocoder, and
with it left out of the whole cascade (``use_silence``)."""
import jax.numpy as jnp
import numpy as np
import pytest

from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.utils.config import DotDict
from test_torch_infer import (BLOCK, K_MAX, SR, Noisy, _diffusion_args,  # noqa: F401
                              _jax_pipeline, _noise, cascade, encoders, nsf,
                              voice)
from torch_helpers import snr_db


@pytest.mark.parametrize("silence_front,use_silence",
                         [(0.0, False), (0.1, False), (0.1, True)])
def test_diffusion_infer_matches_jax(monkeypatch, encoders, cascade, nsf,
                                     silence_front, use_silence):
    jenc, penc = encoders
    jm, params, port = cascade
    a = voice(seed=1)
    t = len(a) // BLOCK + 1
    start = min(int(silence_front * SR / BLOCK), t - 1)
    t_run = t - start if use_silence else t
    noise = _noise(t_run, t * BLOCK)
    jmodel = Noisy(jm, ddsp_noise=jnp.asarray(noise["ddsp"]),
                   init_noise=jnp.asarray(noise["diffusion"]))
    jpipe = _jax_pipeline(monkeypatch, jmodel, params, _diffusion_args(), jenc,
                          nsf[0], noise)
    kw = dict(spk_id=2, key_shift=1.0, silence_front=silence_front,
              use_silence=use_silence, k_step=K_MAX, speedup=10,
              method="dpm-solver")
    want, want_sr = jpipe.infer(a, SR, **kw)

    pipe = SvcPipeline.from_parts(port, None, DotDict(_diffusion_args()), nsf[1],
                                  device="cpu", units_encoder=penc)
    got, sr = pipe.infer(a, SR, noise=noise, **kw)
    assert sr == want_sr == SR
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (t * BLOCK,)
    if start:
        assert np.all(got[:start * BLOCK] == 0.0)
    snr = snr_db(want, got)
    print(f"diffusion infer SNR vs JAX (silence_front {silence_front}, "
          f"use_silence {use_silence}): {snr:.1f} dB")
    assert snr >= 40.0
