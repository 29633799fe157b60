"""The port's plain ops against the JAX package's (jitted on the CPU):
window, upsample, STFT/iSTFT in both pad modes, the excitation sources and
the log-mel front-end. Tolerance 1e-5 relative to the output's peak, 1e-4
for the FFT paths (two FFT libraries).

The phase arithmetic of the sources is elementwise: PyTorch runs it op by
op, which reproduces JAX run op by op to the bit, while XLA's fused jit
lowering contracts multiply-adds and rounds a few quanta away. Those tests
hold the port to eager JAX at the stated tolerance and to jitted JAX at the
looser bound its rounding needs, both stated."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.ops import interp as j_interp
from ddsp_svc_tpu.ops import mel as j_mel
from ddsp_svc_tpu.ops import source as j_source
from ddsp_svc_tpu.ops import spectral as j_spectral
from ddsp_svc_tpu.ops import window as j_window
from ddsp_svc_tpu_torch.ops import interp, mel, source, spectral, window
from torch_helpers import f0_contour, rel_err, tt


def test_hann_window_matches():
    for n in (1, 7, 2048):
        for periodic in (True, False):
            np.testing.assert_array_equal(window.hann_window(n, periodic),
                                          j_window.hann_window(n, periodic))


def test_upsample_matches():
    x = np.random.default_rng(0).standard_normal((2, 13, 3)).astype(np.float32)
    want = jax.jit(j_interp.upsample, static_argnums=1)(jnp.asarray(x), 64)
    got = interp.upsample(tt(x), 64)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("pad_mode,length", [("reflect", 4096 + 300),
                                             ("constant", 900)])
def test_stft_istft_match(pad_mode, length):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, length)).astype(np.float32)
    n_fft, hop = 1024, 256
    want = jax.jit(lambda a: j_spectral.stft(a, n_fft, hop, pad_mode=pad_mode))(
        jnp.asarray(x))
    got = spectral.stft(tt(x), n_fft, hop, pad_mode=pad_mode)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-4
    want_y = jax.jit(lambda s: j_spectral.istft(s, n_fft, hop, length=length))(want)
    got_y = spectral.istft(got, n_fft, hop, length=length)
    assert rel_err(got_y, want_y) <= 1e-4
    if pad_mode == "reflect":  # the reflect-padded pair reconstructs x
        assert rel_err(got_y, x[:, :got_y.shape[1]]) <= 1e-4


def test_phase_increments_and_carry_match():
    f0 = f0_contour(50, base=330.0)
    want_q = jax.jit(j_source.frame_phase_increments_q, static_argnums=(1, 2))(
        jnp.asarray(f0), 44100, 512)
    eager_q = j_source.frame_phase_increments_q(jnp.asarray(f0), 44100, 512)
    got_q = source.frame_phase_increments_q(tt(f0), 44100, 512)
    assert got_q.dtype == torch.int32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(eager_q))
    # jitted XLA contracts the end-of-frame ramp: a few 2^-22-cycle quanta
    assert np.abs(got_q.numpy() - np.asarray(want_q)).max() <= 4
    want_s = jax.jit(j_source.sine_increments_q, static_argnums=(1, 2))(
        jnp.asarray(f0[..., 0]), 512, 44100)
    eager_s = j_source.sine_increments_q(jnp.asarray(f0[..., 0]), 512, 44100)
    got_s = source.sine_increments_q(tt(f0[..., 0]), 512, 44100)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(eager_s))
    assert np.abs(got_s.numpy() - np.asarray(want_s)).max() <= 4


def test_long_utterance_carry_does_not_drift():
    """2^13 + 5 frames of large increments: the JAX int32 prefix overflows
    (natural wrap), torch.cumsum returns int64; masked to 22 bits both give
    the same carries, bit for bit, to the last frame."""
    rng = np.random.default_rng(2)
    t = (1 << 13) + 5
    f0 = rng.uniform(300.0, 800.0, (1, t, 1)).astype(np.float32)
    q = jax.jit(j_source.frame_phase_increments_q, static_argnums=(1, 2))(
        jnp.asarray(f0), 44100, 512)
    assert int(np.abs(np.asarray(q, np.int64)).sum()) > 2 ** 31  # it does overflow
    want = jax.jit(j_source.carry_from_increments_q)(q)
    got = source.carry_from_increments_q(torch.from_numpy(np.array(q)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sine_gen_with_injected_noise_matches():
    rng = np.random.default_rng(3)
    b, t, upp, dim = 2, 20, 64, 9
    f0 = np.concatenate([f0_contour(t), f0_contour(t, base=150.0)], 0)[..., 0]
    rand_ini = rng.random((1, 1, dim)).astype(np.float32)
    rand_ini[..., 0] = 0.0
    noise = rng.standard_normal((b, t * upp, dim)).astype(np.float32)
    want = jax.jit(lambda f, r, n: j_source.sine_gen(
        f, upp, 44100, dim - 1, rand_ini=r, noise=n))(
        jnp.asarray(f0), jnp.asarray(rand_ini), jnp.asarray(noise))
    eager = j_source.sine_gen(jnp.asarray(f0), upp, 44100, dim - 1,
                              rand_ini=jnp.asarray(rand_ini),
                              noise=jnp.asarray(noise))
    got = source.sine_gen(tt(f0), upp, 44100, dim - 1, rand_ini=tt(rand_ini),
                          noise=tt(noise))
    assert got.shape == (b, t * upp, dim)
    assert rel_err(got, eager) <= 1e-5
    # sin of phases up to ~12 cycles: jitted XLA's contracted ramp moves
    # the argument by an f32 ulp, ~1.5e-6 of a 0.13 peak
    assert rel_err(got, want) <= 2e-5


def test_mel_filterbank_matches():
    np.testing.assert_allclose(mel.mel_filterbank(44100, 2048, 128, 40, 16000),
                               j_mel.mel_filterbank(44100, 2048, 128, 40, 16000),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("length", [512 * 24, 700])  # reflect / constant pad
def test_log_mel_matches(length):
    audio = (0.3 * np.random.default_rng(4).standard_normal((1, length))
             ).astype(np.float32)
    jm = j_mel.LogMelSpectrogram()
    want = jax.jit(jm.extract)(jnp.asarray(audio))
    got = mel.LogMelSpectrogram().extract(tt(audio))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-4
