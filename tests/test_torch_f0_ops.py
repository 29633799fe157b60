"""The f0 front end's host parts against the JAX package: the HTK mel
filterbank and CREPE's two pools, the host trackers (DIO, Harvest, praat)
on the committed fixtures, and each wheel branch (pyworld, parselmouth,
torchfcpe) with the same fake module in ``sys.modules`` on both sides.

Tolerances: the filterbank, the median pool and the trackers bit for bit
(the same numpy or a sort); the masked average pool to 1e-7 relative (its
prefix sums in XLA's CPU order, ``blocked_cumsum``); the wheel branches
bit for bit (the same fake arithmetic on both sides); the fixtures' truth
bounds those of tests/test_f0_fixtures.py."""
import glob
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddsp_svc_tpu.features import f0 as jf0
from ddsp_svc_tpu.ops import interp as jinterp
from ddsp_svc_tpu.ops.mel import mel_filterbank as jax_filterbank
from ddsp_svc_tpu_torch.features import f0 as pf0
from ddsp_svc_tpu_torch.ops import interp as pinterp
from ddsp_svc_tpu_torch.ops.mel import mel_filterbank
from torch_f0_helpers import voice

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "f0")
FIXTURES = sorted(glob.glob(os.path.join(FIX, "*.npz")))
# (tracker, median-cents bound against the truth, voiced recall): the
# bounds of tests/test_f0_fixtures.py
TRACKERS = (("dio", 20.0, 0.85), ("harvest", 20.0, 0.85), ("praat", 25.0, 0.80))


@pytest.mark.parametrize("htk", [True, False])
def test_mel_filterbank_matches_jax(htk):
    """RMVPE's (16 kHz, 1024, 128 mels, 30-8000 Hz) with the HTK scale, the
    vocoder's with the Slaney scale: bit for bit."""
    args = (16000, 1024, 128, 30, 8000) if htk else (44100, 2048, 128, 40, 16000)
    np.testing.assert_array_equal(mel_filterbank(*args, htk=htk),
                                  jax_filterbank(*args, htk=htk))


@pytest.mark.parametrize("k", [3, 4, 5])
def test_pools_match_jax(k):
    """Median pool (the lower median at even k) bit for bit; the NaN-masked
    average pool to 1e-7 relative, on a CREPE-like track with NaN runs, a
    NaN at each edge and an all-NaN window."""
    rng = np.random.default_rng(k)
    x = (200.0 + 50.0 * rng.standard_normal((2, 301))).astype(np.float32)
    np.testing.assert_array_equal(
        pinterp.median_pool_1d(torch.from_numpy(x), k).numpy(),
        np.asarray(jinterp.median_pool_1d(jnp.asarray(x), k)))
    x[0, :3] = np.nan
    x[0, 100:140] = np.nan
    x[1, rng.random(301) < 0.3] = np.nan
    x[1, -1] = np.nan
    got = pinterp.masked_avg_pool_1d(torch.from_numpy(x), k).numpy()
    want = np.asarray(jinterp.masked_avg_pool_1d(jnp.asarray(x), k))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("path", FIXTURES, ids=[
    os.path.splitext(os.path.basename(p))[0] for p in FIXTURES])
@pytest.mark.parametrize("tracker,cents_bound,recall", TRACKERS)
def test_host_trackers_match_jax(path, tracker, cents_bound, recall):
    """Each tracker through ``F0Extractor`` equals the JAX package's bit for
    bit on the fixture, and keeps the fixture's truth bounds."""
    data = np.load(path)
    audio = data["audio"].astype(np.float32)
    sr, hop = int(data["sr"]), int(data["hop"])
    got = pf0.F0Extractor(tracker, sr, hop, 50.0, 1100.0).extract(audio)
    want = jf0.F0Extractor(tracker, sr, hop, 50.0, 1100.0).extract(audio)
    np.testing.assert_array_equal(got, want)
    truth = data["f0_truth"]
    n = min(len(got), len(truth)) - 8
    f0, truth = got[4:4 + n], truth[4:4 + n]
    voiced = f0 > 0
    assert voiced.mean() >= recall
    err = 1200 * np.abs(np.log2(f0[voiced] / truth[voiced]))
    assert np.median(err) < cents_bound


def test_host_trackers_silence_front_and_uv_interp():
    """``silence_front`` and ``uv_interp`` on each tracker, bit for bit."""
    audio = voice(0.6, 16000, seed=5)
    audio[4000:5000] = 0.0
    for kind in ("dio", "harvest", "praat", "parselmouth", "yin"):
        for uv, sf in ((False, 0.1), (True, 0.0), (True, 0.13)):
            got = pf0.F0Extractor(kind, 16000, 160, 60.0, 900.0).extract(
                audio, uv_interp=uv, silence_front=sf)
            want = jf0.F0Extractor(kind, 16000, 160, 60.0, 900.0).extract(
                audio, uv_interp=uv, silence_front=sf)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {uv} {sf}")


def _fake_wheels(calls: list) -> dict:
    """Stand-ins for the pyworld, parselmouth and torchfcpe wheels: each
    records its call and returns arithmetic of its input."""
    def dio(x, fs, f0_floor, f0_ceil, channels_in_octave, frame_period):
        calls.append(("dio", len(x), fs, f0_floor, f0_ceil, channels_in_octave,
                      frame_period))
        n = int(len(x) / fs * 1000 / frame_period) + 1
        return 100.0 + np.arange(n, dtype=np.float64), np.arange(n) * 0.01

    def stonemask(x, f0, t, fs):
        calls.append(("stonemask", len(x), len(f0), fs))
        return f0 * 1.5

    def harvest(x, fs, f0_floor, f0_ceil, frame_period):
        calls.append(("harvest", len(x), fs, f0_floor, f0_ceil, frame_period))
        n = int(len(x) / fs * 1000 / frame_period) + 1
        return 150.0 + np.abs(x[:n]) * 10.0, np.arange(n) * 0.01

    pyworld = types.SimpleNamespace(dio=dio, stonemask=stonemask, harvest=harvest)

    class Sound:
        def __init__(self, values, rate):
            self.values, self.rate = np.asarray(values), rate

        def to_pitch_ac(self, time_step, voicing_threshold, pitch_floor,
                        pitch_ceiling):
            calls.append(("to_pitch_ac", len(self.values), self.rate, time_step,
                          voicing_threshold, pitch_floor, pitch_ceiling))
            n = int((len(self.values) / self.rate - 3.0 / pitch_floor)
                    / time_step) + 1
            return types.SimpleNamespace(
                t1=1.5 / pitch_floor,
                selected_array={"frequency": 200.0 + np.arange(n) % 7})

    parselmouth = types.SimpleNamespace(Sound=Sound)

    def spawn_bundled_infer_model(device):
        calls.append(("spawn", device))

        def infer(audio, sr, decoder_mode, threshold):
            calls.append(("fcpe", tuple(audio.shape), sr, decoder_mode, threshold))
            n = audio.shape[1] * 16000 // sr // 160 + 1
            f0 = 180.0 + torch.arange(n, dtype=torch.float32)
            f0[::5] = 0.0
            return f0[None, :, None]
        return infer

    torchfcpe = types.SimpleNamespace(
        spawn_bundled_infer_model=spawn_bundled_infer_model)
    return {"pyworld": pyworld, "parselmouth": parselmouth,
            "torchfcpe": torchfcpe}


@pytest.mark.parametrize("kind", ["dio", "harvest", "parselmouth", "fcpe"])
def test_wheel_branches_match_jax(kind, monkeypatch):
    """With the same fake wheel installed, the port takes the branch JAX
    takes, calls the wheel with the same arguments and returns the same f0
    (bit for bit); 'praat' keeps the host tracker even then."""
    calls = {"jax": [], "port": []}
    audio = voice(0.5, 16000, seed=6)
    out = {}
    for side, module in (("jax", jf0), ("port", pf0)):
        with monkeypatch.context() as m:
            for name, mod in _fake_wheels(calls[side]).items():
                m.setitem(sys.modules, name, mod)
            kw = {"device": "cpu"} if side == "port" else {}
            ext = module.F0Extractor(kind, 16000, 160, 60.0, 900.0, **kw)
            out[side] = [ext.extract(audio, uv_interp=uv, silence_front=sf)
                         for uv, sf in ((False, 0.0), (True, 0.1))]
            if kind == "parselmouth":
                praat = module.F0Extractor("praat", 16000, 160, 60.0, 900.0)
                out[side].append(praat.extract(audio))
    assert calls["port"] == calls["jax"] and calls["jax"]
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    if kind == "parselmouth":
        np.testing.assert_array_equal(
            out["port"][-1], jf0.F0Extractor("praat", 16000, 160, 60.0,
                                             900.0).extract(audio))


def test_unknown_and_weightless_extractors(tmp_path, monkeypatch, capsys):
    """An unknown kind raises ``ValueError``; a net without converted
    weights falls back to YIN with the JAX package's warning, on both
    sides."""
    with pytest.raises(ValueError, match="Unknown or unavailable"):
        pf0.F0Extractor("swipe")
    for kind in ("rmvpe", "crepe", "fcpe"):
        monkeypatch.setenv(f"DDSP_SVC_TPU_{kind.upper()}_CKPT",
                           str(tmp_path / "absent.msgpack"))
        ext = pf0.F0Extractor(kind, 16000, 160)
        assert ext.f0_extractor == "yin" and ext.net is None
        port_msg = capsys.readouterr().out
        assert jf0.F0Extractor(kind, 16000, 160).f0_extractor == "yin"
        assert port_msg == capsys.readouterr().out != ""
