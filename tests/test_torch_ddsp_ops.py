"""The DDSP family's building blocks in the port against the JAX package,
on the CPU: the K4 plain version (against the Pallas kernel in interpret
mode and the model's own ``sins_harmonic_bank``), the cumsum phase source
(bit for bit against eager JAX), ``remove_above_fmax``, the windows, the
LTV-FIR ops, the resampler and the normed conformer conv module.
Tolerances are stated per test, starting from the JAX package's own."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.conformer import ConformerConvModule as JConv
from ddsp_svc_tpu.models.ddsp import sins_harmonic_bank as j_sins_bank
from ddsp_svc_tpu.ops import fir as j_fir
from ddsp_svc_tpu.ops import interp as j_interp
from ddsp_svc_tpu.ops import resample as j_resample
from ddsp_svc_tpu.ops import source as j_source
from ddsp_svc_tpu.ops import window as j_window
from ddsp_svc_tpu.ops.pallas_oscillator import harmonic_bank_pallas
from ddsp_svc_tpu_torch.io.jax_params import _put_conformer, _Leaves, load_state
from ddsp_svc_tpu_torch.models.conformer import ConformerConvModule
from ddsp_svc_tpu_torch.models.ddsp import sins_harmonic_bank
from ddsp_svc_tpu_torch.ops import fir, interp, resample, source, window
from ddsp_svc_tpu_torch.ops.cuda_oscillator import harmonic_bank, harmonic_bank_plain
from torch_helpers import randomize_tree, rel_err, tt


def _bank_inputs(b, t, block, n_harm, sr, seed):
    """Phase in cycles from the JAX cumsum source, softplus amplitudes."""
    rng = np.random.default_rng(seed)
    f0 = (150.0 * np.exp(0.3 * rng.standard_normal((b, t, 1)))).astype(np.float32)
    x = np.asarray(j_source.cumsum_phase_source(
        jnp.asarray(np.repeat(f0, block, axis=1)), sr, block))
    amps = (np.log1p(np.exp(rng.standard_normal((b, t, n_harm)))) * 0.05
            ).astype(np.float32)
    return x, amps


@pytest.mark.parametrize("b,t,block,n_harm", [(2, 13, 64, 24), (2, 5, 512, 128)])
def test_harmonic_bank_plain_matches_pallas_and_model(b, t, block, n_harm):
    """K4's plain version computes the Pallas kernel's formula: 2e-6
    absolute against it in interpret mode (the same arithmetic; only the
    sum order over harmonics and the libraries' sin differ). Against the
    model's radians form (``sins_harmonic_bank``), the JAX test's 3e-5
    (tests/test_pallas_oscillator.py). B = 2 and an odd T: the next-frame
    amplitudes repeat each row's own last frame."""
    x, amps = _bank_inputs(b, t, block, n_harm, 16000, seed=t)
    ref = np.asarray(j_sins_bank(2.0 * np.pi * jnp.asarray(x), jnp.asarray(amps),
                                 block))
    got = harmonic_bank_plain(tt(x), tt(amps), block).numpy()
    assert got.shape == (b, t * block)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    if block == 64:  # interpret mode runs the 8-frame tiles one by one
        pallas = np.asarray(harmonic_bank_pallas(
            jnp.asarray(x), jnp.asarray(amps), block, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=2e-6, rtol=0)
    # the wrapper takes the plain version on CPU tensors and launches nothing
    harmonic_bank.launches = 0
    assert torch.equal(harmonic_bank(tt(x), tt(amps), block), tt(got))
    assert harmonic_bank.launches == 0
    # the port's radians form is the JAX model's
    port_ref = sins_harmonic_bank(2.0 * np.pi * tt(x), tt(amps), block).numpy()
    np.testing.assert_allclose(port_ref, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("b,t,block,n_harm", [(2, 13, 64, 40), (1, 5, 441, 24)])
def test_harmonic_bank_bf16_amplitude_mode_matches_jax(b, t, block, n_harm):
    """bf16 amplitudes: K4's plain version takes the bf16-amplitude mode and
    equals the JAX Sins bank on the same bf16 amplitudes (their upsample in
    bf16) to the 3e-5 of the f32 mode; the f32 mode on the widened
    amplitudes does not (block 441 also checks that the block is rounded to
    bf16 as JAX's weak typing rounds it)."""
    x, amps = _bank_inputs(b, t, block, n_harm, 16000, seed=t)
    amps = amps * 4.0
    ref = np.asarray(j_sins_bank(2.0 * np.pi * jnp.asarray(x),
                                 jnp.asarray(amps).astype(jnp.bfloat16), block))
    bf = tt(amps).to(torch.bfloat16)
    got = harmonic_bank_plain(tt(x), bf, block)
    assert got.dtype == torch.float32 and got.shape == (b, t * block)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=0)
    widened = harmonic_bank_plain(tt(x), bf.float(), block).numpy()
    assert np.abs(widened - ref).max() > 3e-5
    harmonic_bank.launches = 0
    assert torch.equal(harmonic_bank(tt(x), bf, block), got)
    assert harmonic_bank.launches == 0


def test_harmonic_bank_rows_do_not_bleed():
    """Row 1's last frame interpolates towards itself, not towards row 2's
    first frame: computing each row alone gives the same samples."""
    x, amps = _bank_inputs(2, 7, 64, 16, 16000, seed=3)
    both = harmonic_bank_plain(tt(x), tt(amps), 64)
    for i in range(2):
        alone = harmonic_bank_plain(tt(x[i:i + 1]), tt(amps[i:i + 1]), 64)
        assert torch.equal(both[i:i + 1], alone)


@pytest.mark.parametrize("b,t,block,sr,cycles", [
    (2, 13, 64, 16000, 0.6),      # the JAX oscillator test's shapes
    (1, 40, 512, 44100, 5.3),     # the model's block at 44.1 kHz
    (2, 2000, 32, 16000, 14.4)])  # int32 prefix overflows after ~1300 frames
def test_cumsum_phase_source_bit_exact(b, t, block, sr, cycles):
    """Bit for bit against eager JAX: the port sums each frame in XLA's
    CPU order (ops/source.blocked_cumsum) and carries the same int32
    quanta. The third case's integer prefix passes 2^31, so the 22-bit mask
    of the int64 prefix is what keeps it equal."""
    rng = np.random.default_rng(t)
    f0 = (sr / block * (cycles + 0.05 * rng.standard_normal((b, t, 1)))
          ).astype(np.float32)
    f0u = np.repeat(f0, block, axis=1)
    init = rng.uniform(-3.0, 3.0, (b, 1, 1)).astype(np.float32)
    q = np.asarray(j_source.cumsum_increments_q(jnp.asarray(f0u), sr, block))
    if t == 2000:
        assert np.cumsum(q.astype(np.int64), axis=1).max() > 2 ** 31
    np.testing.assert_array_equal(
        source.cumsum_increments_q(tt(f0u), sr, block).numpy(), q)
    want = np.asarray(j_source.cumsum_phase_source(
        jnp.asarray(f0u), sr, block, jnp.asarray(init)))
    got = source.cumsum_phase_source(tt(f0u), sr, block, tt(init)).numpy()
    np.testing.assert_array_equal(got, want)


def test_remove_above_fmax_and_windows_match():
    rng = np.random.default_rng(0)
    amps = rng.random((2, 9, 40)).astype(np.float32)
    f0 = np.concatenate([rng.uniform(50, 1200, (2, 8, 1)), np.zeros((2, 1, 1))],
                        axis=1).astype(np.float32)
    want = j_interp.remove_above_fmax(jnp.asarray(amps), jnp.asarray(f0), 22050.0)
    got = interp.remove_above_fmax(tt(amps), tt(f0), 22050.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n in (1, 8, 1023, 1024):
        for periodic in (True, False):
            for name in ("sqrt_hann_window", "bartlett_window"):
                np.testing.assert_array_equal(
                    getattr(window, name)(n, periodic),
                    getattr(j_window, name)(n, periodic))


@pytest.mark.parametrize("n_frames,ir,hann,dynamic", [
    (8, 510, False, False),   # Sins' all-pass: 256 bins
    (8, 158, True, False),    # Sins' noise filter: 80 bins
    (8, 1022, True, True),    # CombSub's dynamic-window harmonic filter
    (1, 64, True, False)])    # one frame: the time-invariant case
def test_frequency_filter_matches(n_frames, ir, hann, dynamic):
    """fft_convolve and the IR windows through ``frequency_filter``, 1e-4
    relative to the peak (two FFT libraries; tests/test_ops_fir.py holds the
    JAX side to the reference formulas at 1e-3)."""
    rng = np.random.default_rng(ir)
    audio = rng.standard_normal((2, n_frames * 512)).astype(np.float32)
    n_bins = ir // 2 + 1
    mags = (rng.uniform(0.1, 1.0, (2, n_frames, n_bins))
            * np.exp(1j * rng.uniform(-np.pi, np.pi, (2, n_frames, n_bins)))
            ).astype(np.complex64)
    half = (rng.uniform(30, 400, (2, n_frames, 1)).astype(np.float32)
            if dynamic else None)
    want = j_fir.frequency_filter(jnp.asarray(audio), jnp.asarray(mags), hann,
                                  None if half is None else jnp.asarray(half))
    got = fir.frequency_filter(tt(audio), torch.from_numpy(mags), hann,
                               None if half is None else tt(half))
    assert got.shape == audio.shape
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("window_size", [0, 48])
def test_apply_window_to_impulse_response_matches(window_size):
    ir = np.random.default_rng(window_size).standard_normal((2, 3, 64)).astype(np.float32)
    for causal in (False, True):
        want = j_fir.apply_window_to_impulse_response(jnp.asarray(ir), window_size, causal)
        got = fir.apply_window_to_impulse_response(tt(ir), window_size, causal)
        assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("orig,new", [(44100, 48000), (48000, 44100),
                                      (44100, 52400), (52400, 44100),
                                      (44100, 62400)])
def test_resample_matches(orig, new):
    """The sinc_interp_hann resampler at 44.1k <-> 48k and the adaptive-key
    rates of +3 and +6 semitones (52.4k, 62.4k): the same kernel, one
    strided conv here against block matmuls in JAX, 1e-5 relative."""
    x = np.random.default_rng(orig % 997).standard_normal((2, 3001)).astype(np.float32)
    want = np.asarray(j_resample.resample(jnp.asarray(x), orig, new))
    got = resample.resample(tt(x), orig, new).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5
    assert resample.resample(tt(x), orig, orig) is not None


def test_conformer_conv_module_with_norm_matches():
    """PCmer's conv module (LayerNorm first), 1e-5 relative."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, 32)).astype(np.float32)
    jm = JConv(32, use_norm=True)
    params = randomize_tree(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"], seed=1)
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = ConformerConvModule(32, use_norm=True)
    sd: dict = {}
    tree = _Leaves({"m": params})
    _put_conformer(sd, tree, "m", "m", use_norm=True)
    tree.finish()
    load_state(port, {k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(tt(x))
    assert rel_err(got, want) <= 1e-5
