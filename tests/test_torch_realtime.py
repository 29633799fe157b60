"""The realtime SOLA engine (``infer/realtime.py``: ``phase_vocoder``,
``RealtimeVC``, ``drive_blocks``) against the JAX package's on the same
blocks:

- ``phase_vocoder`` to 1e-12 (both sides are float64 numpy);
- the pass-through and delay stand-in pipelines of tests/test_realtime.py
  (and a delay that moves from block to block) driving both engines, with
  the cross-fade and with the phase vocoder: the same SOLA offset chosen
  in every block and the spliced output within 1e-6;
- one block sequence through a small DiffusionFast ``SvcPipeline`` on each
  side (the fixtures of tests/test_torch_infer.py), the same noise injected
  into every block: the spliced output >= 40 dB SNR, the bar every whole
  conversion is held to."""
import jax.numpy as jnp
import numpy as np
import pytest

import ddsp_svc_tpu.infer.realtime as jrt
import ddsp_svc_tpu_torch.infer.realtime as prt
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.utils.config import DotDict
from test_torch_infer import (BLOCK, K_MAX, SR, Noisy, _diffusion_args,  # noqa: F401
                              _jax_pipeline, _noise, cascade, encoders, nsf,
                              voice)
from torch_helpers import snr_db


class PassthroughPipeline:
    """Identity 'conversion': returns its rolling context unchanged."""

    def infer(self, audio, sample_rate, **kwargs):
        return audio.copy(), sample_rate


class JitterPipeline:
    """Identity plus a small delay, which SOLA must re-align: constant (as
    in tests/test_realtime.py), or with ``vary`` 0, 1 or 2 times ``shift``
    by turns, so that the offsets move from block to block."""

    def __init__(self, shift, vary=False):
        self.shift, self.vary, self.calls = shift, vary, 0

    def infer(self, audio, sample_rate, **kwargs):
        self.calls += 1
        shift = self.shift * (self.calls % 3) if self.vary else self.shift
        return np.roll(audio, shift), sample_rate


def test_phase_vocoder_matches_jax():
    rng = np.random.default_rng(70)
    for n in (256, 255):
        fade_in = np.sin(np.pi * np.arange(n) / n / 2) ** 2
        a, b = rng.standard_normal(n), rng.standard_normal(n)
        want = jrt.phase_vocoder(a, b, 1.0 - fade_in, fade_in)
        got = prt.phase_vocoder(a, b, 1.0 - fade_in, fade_in)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _offsets(monkeypatch):
    """Record every SOLA offset the engines take (np.argmax of the
    normalised cross-correlation, the only argmax in either engine)."""
    seen = []
    argmax = np.argmax

    def recording(a, *args, **kwargs):
        i = argmax(a, *args, **kwargs)
        seen.append(int(i))
        return i

    monkeypatch.setattr(np, "argmax", recording)
    return seen


@pytest.mark.parametrize("shift,vary", [(0, False), (37, False), (-23, True)])
@pytest.mark.parametrize("phase_vocoder", [False, True])
def test_engine_matches_jax_on_stand_ins(monkeypatch, shift, vary, phase_vocoder):
    sr = 16000
    t = np.arange(sr * 2) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    seen = _offsets(monkeypatch)
    outs, offsets = [], []
    for engine in (jrt, prt):
        pipe = JitterPipeline(shift, vary) if shift else PassthroughPipeline()
        vc = engine.RealtimeVC(pipe, sample_rate=sr, block_time=0.1,
                               crossfade_time=0.02, extra_time=0.4,
                               use_phase_vocoder=phase_vocoder)
        seen.clear()
        out, stats = engine.drive_blocks(vc, audio)
        outs.append(out)
        offsets.append(list(seen))
        assert stats["blocks"] == 20 and len(stats["times_s"]) == 20
    assert len(offsets[0]) == 19 and offsets[0] == offsets[1]
    if vary:
        assert len(set(offsets[1])) > 1  # SOLA follows the moving delay
    assert outs[1].shape == audio.shape
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)


def test_engine_refuses_a_wrong_block():
    vc = prt.RealtimeVC(PassthroughPipeline(), sample_rate=16000, block_time=0.1)
    with pytest.raises(ValueError, match="1600 samples"):
        vc.process_block(np.zeros(100, np.float32))


def test_diffusion_blocks_match_jax(monkeypatch, encoders, cascade, nsf):
    """Six 0.1 s blocks with 0.4 s of extra context (silence_front 0.3 s
    each) through both engines on a 2-layer DiffusionFast pipeline."""
    jenc, penc = encoders
    jm, params, port = cascade
    kw = dict(sample_rate=SR, block_time=0.1, crossfade_time=0.02,
              extra_time=0.4, key_shift=1.0, spk_id=2)
    context = int(0.4 * SR) + int(0.1 * SR)
    t = context // BLOCK + 1
    noise = _noise(t, t * BLOCK)
    jmodel = Noisy(jm, ddsp_noise=jnp.asarray(noise["ddsp"]),
                   init_noise=jnp.asarray(noise["diffusion"]))
    jpipe = _jax_pipeline(monkeypatch, jmodel, params, _diffusion_args(), jenc,
                          nsf[0], noise)
    pipe = SvcPipeline.from_parts(port, None, DotDict(_diffusion_args()), nsf[1],
                                  device="cpu", units_encoder=penc)
    sampler = dict(k_step=K_MAX, speedup=10, method="dpm-solver")
    audio = np.concatenate([voice(seed=3), voice(seed=4)])[:6 * int(0.1 * SR)]
    want = jrt.RealtimeVC(jpipe, **kw, **sampler).process_stream(audio)
    vc = prt.RealtimeVC(pipe, **kw, **sampler, noise=noise)
    got = vc.process_stream(audio)
    assert got.shape == want.shape == audio.shape
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    snr = snr_db(want, got)
    print(f"realtime DiffusionFast blocks SNR vs JAX: {snr:.1f} dB")
    assert snr >= 40.0


class RecordingPipeline(PassthroughPipeline):
    """A stand-in of a mel cascade that records each call's arguments."""

    family = "diffusion"

    def __init__(self):
        self.calls = []

    def infer(self, audio, sample_rate, **kwargs):
        self.calls.append(dict(kwargs))
        return super().infer(audio, sample_rate)


def test_warmup_matches_jax_and_keeps_the_engine_state():
    """warmup runs one silent block per variant (the arguments, the other
    ``use_silence`` for a cascade, the extra variants), as the JAX engine
    does, and leaves the rolling input, the SOLA buffer and the first-block
    flag as they were."""
    rng = np.random.default_rng(71)
    block = rng.standard_normal(1600).astype(np.float32)
    calls = {}
    for engine in (jrt, prt):
        pipe = RecordingPipeline()
        vc = engine.RealtimeVC(pipe, sample_rate=16000, block_time=0.1,
                               extra_time=0.4, use_silence=False, k_step=100)
        vc.process_block(block)
        state = (vc.input_wav.copy(), vc.sola_buffer.copy(), vc._first)
        vc.warmup([{"k_step": 50}])
        assert np.array_equal(vc.input_wav, state[0])
        assert np.array_equal(vc.sola_buffer, state[1]) and vc._first == state[2]
        assert vc.infer_kwargs == {"use_silence": False, "k_step": 100}
        calls[engine] = pipe.calls
    assert calls[prt] == calls[jrt]
    assert [(c["use_silence"], c["k_step"]) for c in calls[prt][1:]] == [
        (False, 100), (True, 100), (False, 50)]
