"""The port's host front end against the JAX package on the same inputs:
wav I/O, the silence slicer and the host YIN bit for bit; the device YIN
(features/yin_device.py) against JAX's ``make_pipeline_f0_fn`` run eagerly
on the CPU and against the host YIN, with identical voicing and < 0.05
cents on voiced frames (the JAX package's own bound for its device YIN,
tests/test_yin_jax.py)."""
import struct

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from ddsp_svc_tpu.features import audio as jaudio
from ddsp_svc_tpu.features import f0 as jf0
from ddsp_svc_tpu.features import slicer as jslicer
from ddsp_svc_tpu.features import yin_jax
from ddsp_svc_tpu_torch.features import audio, f0, slicer, yin_device
import torch_helpers  # noqa: F401,E402  (torch's threads under xdist)

SR, HOP = 44100, 512


def _voice(seconds, hz=220.0, seed=0, silences=()):
    """A vibrato tone with light noise; each (start, stop) second span of
    ``silences`` is zeroed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    f_inst = hz * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    a = 0.3 * np.sin(2 * np.pi * np.cumsum(f_inst) / SR)
    a = (a + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    for lo, hi in silences:
        a[int(lo * SR):int(hi * SR)] = 0.0
    return a


def _write_pcm24(path, data, sr):
    """A 24-bit PCM RIFF file (scipy writes no 24-bit wavs)."""
    data = np.atleast_2d(np.asarray(data, np.int32).T).T
    n_ch = data.shape[1]
    raw = b"".join(int(v).to_bytes(3, "little", signed=True) for v in data.ravel())
    fmt = struct.pack("<HHIIHH", 1, n_ch, sr, sr * 3 * n_ch, 3 * n_ch, 24)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16) + fmt)
        f.write(b"data" + struct.pack("<I", len(raw)) + raw)


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "pcm32", "float32",
                                  "stereo16"])
def test_load_wav_matches(tmp_path, kind):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (3001, 2) if kind == "stereo16" else 3001)
    path = tmp_path / f"{kind}.wav"
    if kind == "pcm24":
        _write_pcm24(path, np.round(x * 2 ** 23), 22050)
    elif kind == "float32":
        wavfile.write(path, 22050, x.astype(np.float32))
    else:
        bits = {"pcm16": 16, "stereo16": 16, "pcm32": 32}[kind]
        dtype = np.int16 if bits == 16 else np.int32
        wavfile.write(path, 22050, np.round(x * 2 ** (bits - 1)).astype(dtype))
    for mono in (True, False):
        got, sr = audio.load_wav(str(path), mono=mono)
        want, want_sr = jaudio.load_wav(str(path), mono=mono)
        assert sr == want_sr == 22050
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if kind == "pcm24":  # scipy hands 24-bit samples over as int32
        np.testing.assert_allclose(got, x, atol=2 ** -22)


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_save_wav_matches(tmp_path, subtype):
    x = np.random.default_rng(2).uniform(-1.2, 1.2, 4000)  # clips in PCM16
    audio.save_wav(str(tmp_path / "port.wav"), x, 16000, subtype)
    jaudio.save_wav(str(tmp_path / "jax.wav"), x, 16000, subtype)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("seconds,silences", [
    (12.0, ()), (12.0, ((6.0, 6.8),)),
    (26.0, ((6.0, 6.8), (12.5, 13.0), (19.0, 20.0)))],
    ids=["none", "one", "three"])
def test_split_audio_matches(seconds, silences):
    """The slicer cuts at a silence of >= 0.3 s once the clip before it
    reaches 5 s: 1, 2 and 4 segments."""
    a = _voice(seconds, silences=silences, seed=3)
    got = slicer.split_audio(a, SR)
    want = jslicer.split_audio(a, SR)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got) == len(silences) + 1
    assert slicer.Slicer(SR).slice(a) == jslicer.Slicer(SR).slice(a)


@pytest.mark.parametrize("uv_interp", [False, True])
@pytest.mark.parametrize("silence_front", [0.0, 0.37])
def test_host_yin_bit_exact(uv_interp, silence_front):
    a = _voice(1.7, silences=((0.0, 0.3), (0.9, 1.1)), seed=4)
    got = f0.F0Extractor("yin", SR, HOP, 50.0, 1100.0).extract(
        a, uv_interp=uv_interp, silence_front=silence_front)
    want = jf0.F0Extractor("yin", SR, HOP, 50.0, 1100.0).extract(
        a, uv_interp=uv_interp, silence_front=silence_front)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 40


def test_f0_nets_fall_back_to_yin_without_weights(capsys, monkeypatch,
                                                  tmp_path):
    monkeypatch.chdir(tmp_path)  # no pretrain/ here
    a = _voice(0.6, seed=5)
    for kind in ("rmvpe", "crepe", "fcpe"):
        monkeypatch.delenv(f"DDSP_SVC_TPU_{kind.upper()}_CKPT", raising=False)
        got = f0.F0Extractor(kind, SR, HOP).extract(a, uv_interp=True)
        port_msg = capsys.readouterr().out
        if kind != "fcpe":  # JAX tries the torchfcpe wheel first
            want = jf0.F0Extractor(kind, SR, HOP).extract(a, uv_interp=True)
            assert capsys.readouterr().out == port_msg
            np.testing.assert_array_equal(got, want)
        assert "falling back to the built-in YIN" in port_msg


def _same_voicing_and_cents(got, want):
    assert got.shape == want.shape
    assert ((got > 0) == (want > 0)).all()
    both = want > 0
    assert both.sum() > 20
    assert np.abs(1200 * np.log2(got[both] / want[both])).max() < 0.05


@pytest.mark.parametrize("hz,silences,hop", [
    (220.0, (), HOP), (440.0, ((1.0, 1.5),), HOP),
    (180.0, ((0.2, 0.4),), 441)])  # hop 441 blocks the decimation
def test_device_yin_matches_host(hz, silences, hop):
    a = _voice(2.0, hz=hz, silences=silences, seed=6)[:SR * 2 - 37]
    want = jf0.yin_f0(a, SR, hop, 50.0, 1100.0)
    got = yin_device.make_yin_fn(len(a), SR, hop, 50.0, 1100.0)(
        torch.from_numpy(a)).numpy()
    _same_voicing_and_cents(got, want)


def test_device_yin_silence_is_unvoiced():
    fn = yin_device.make_yin_fn(SR, SR, HOP, 50.0, 1100.0)
    assert (fn(torch.zeros(SR)).numpy() == 0).all()


@pytest.mark.parametrize("silence_front", [0.0, 0.5, 1.0])
def test_device_pipeline_f0_matches_jax(silence_front):
    a = _voice(2.3, hz=200.0, silences=((0.0, 0.5),), seed=7)
    start = int(silence_front * SR / HOP)
    want = np.asarray(yin_jax.make_pipeline_f0_fn(
        len(a), SR, HOP, 50.0, 1100.0, start)(jnp.asarray(a)))
    got = yin_device.make_pipeline_f0_fn(len(a), SR, HOP, 50.0, 1100.0, start)(
        torch.from_numpy(a)).numpy()
    assert got.shape == want.shape
    assert np.abs(1200 * np.log2(got / want)).max() < 0.05
    host = f0.F0Extractor("yin", SR, HOP, 50.0, 1100.0).extract(
        a, uv_interp=True, silence_front=silence_front)
    assert np.abs(1200 * np.log2(got / host)).max() < 0.05


@pytest.mark.parametrize("pat", [
    [0, 0, 100, 0, 0, 200, 0, 0], [0.0] * 16, [150.0] * 16,
    [100.0, 0, 0, 0], [0, 0, 0, 300.0]])
def test_interp_unvoiced_matches(pat):
    pat = np.asarray(pat, np.float32)
    want = np.asarray(yin_jax.interp_unvoiced(jnp.asarray(pat)))
    got = yin_device.interp_unvoiced(torch.from_numpy(pat)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jf0._interp_unvoiced(pat.copy()),
                               rtol=1e-6, atol=1e-6)


def test_build_f0_extractor_matches(capsys, monkeypatch, tmp_path):
    """cli/common.build_f0_extractor: the config's tracker on the model's
    hop grid; 'rmvpe' without weights falls back to YIN as JAX's does."""
    from ddsp_svc_tpu.cli.common import build_f0_extractor as j_build
    from ddsp_svc_tpu.utils.config import DotDict as JDotDict
    from ddsp_svc_tpu_torch.cli.common import build_f0_extractor
    from ddsp_svc_tpu_torch.utils.config import DotDict

    monkeypatch.chdir(tmp_path)
    data = {"f0_extractor": "rmvpe", "sampling_rate": SR, "block_size": HOP,
            "f0_min": 65, "f0_max": 800}
    got = build_f0_extractor(DotDict({"data": data}))
    port_msg = capsys.readouterr().out
    want = j_build(JDotDict({"data": data}))
    assert capsys.readouterr().out == port_msg and "YIN" in port_msg
    assert got.f0_extractor == want.f0_extractor == "yin"
    a = _voice(0.8, seed=8)
    np.testing.assert_array_equal(got.extract(a), want.extract(a))
