"""``python -m ddsp_svc_tpu_torch.cli.infer --stream 2 --device cpu``
against the JAX CLI's ``--stream 2`` on checkpoints the JAX package writes
(CombSubSuperFast, and Sins with its FAVOR+ buffers), as
tests/test_torch_cli.py compares the unstreamed CLIs: the noise filter's
bias at -30 so the two CLIs' different draws do not show, the same length,
rate and PCM16 type, >= 40 dB SNR. An 11 s recording with a silence (two
segments, spliced), and a 0.4 s one whose single segment is shorter than
N (FRAME_HALO + 8) frames, so both CLIs pad it. The port's ``--stream 2``
run twice on one recording (each run in a world of its own) writes the
same samples. ``-mix`` with ``--stream`` is refused with the JAX CLI's
words.
"""
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.cli.infer as jcli
import ddsp_svc_tpu_torch.cli.infer as pcli
from ddsp_svc_tpu.convert.flatdict import flatten
from ddsp_svc_tpu.features import hubert as jh
from ddsp_svc_tpu.models import ddsp as jddsp
from ddsp_svc_tpu.models.pcmer import gaussian_orthogonal_random_matrix
from ddsp_svc_tpu.train.checkpoint import save_checkpoint
from ddsp_svc_tpu.utils.config import save_config
from torch_helpers import randomize_tree, snr_db

SR, HOP, WIN, N_UNIT = 16000, 64, 256, 256
SINS = dict(n_harmonics=24, n_mag_allpass=16, n_mag_noise=12)


def _write_wav(path, seconds, silences=()):
    n = np.arange(int(SR * seconds))
    f = 220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * n / SR))
    audio = (0.4 * np.sin(2 * np.pi * np.cumsum(f) / SR)
             * np.minimum(1.0, n / 800.0))
    for lo, hi in silences:
        audio[int(lo * SR):int(hi * SR)] = 0.0
    wavfile.write(path, SR, (audio * 32767).astype(np.int16))
    return path


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    """The tiny units encoder's weights, one file for every checkpoint."""
    path = tmp_path_factory.mktemp("encoder") / "encoder.npz"
    np.savez(path, **flatten({"params": randomize_tree(
        jh.UnitsEncoder("tiny").variables["params"], seed=31)}))
    return path


def _checkpoint(d, mtype, encoder):
    """A checkpoint and config.yaml of the JAX package, two speakers, the
    noise filter's magnitude bias at -30 (exp(-30): off)."""
    if mtype == "Sins":
        jm = jddsp.Sins(SR, HOP, n_unit=N_UNIT, n_spk=2, **SINS)
        noise_bins = slice(-SINS["n_mag_noise"], None)
        model = dict(type="Sins", n_spk=2, **SINS)
    else:
        jm = jddsp.CombSubSuperFast(SR, HOP, WIN, n_unit=N_UNIT, n_spk=2)
        f_bins = WIN // 2 + 1
        noise_bins = slice(2 * f_bins, 3 * f_bins)
        model = dict(type="CombSubSuperFast", win_length=WIN, n_spk=2)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, N_UNIT)), 220.0 * jnp.ones((1, 16, 1)),
        jnp.ones((1, 16, 1)), spk_id=jnp.ones((1, 1), jnp.int32)))
    params = randomize_tree(shapes["params"], seed=41)
    bias = np.array(params["unit2ctrl"]["dense_out"]["bias"])
    bias[noise_bins] = -30.0
    params["unit2ctrl"]["dense_out"]["bias"] = bias
    extra = None
    if "buffers" in shapes:
        extra = {"buffers": jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.asarray(gaussian_orthogonal_random_matrix(
                jax.random.PRNGKey(int(path[-3].key[-1])), *leaf.shape)),
            shapes["buffers"])}
    save_checkpoint(str(d), 5, params, extra=extra)
    save_config(d / "config.yaml", {
        "data": {"sampling_rate": SR, "block_size": HOP, "duration": 2,
                 "encoder": "tiny", "encoder_ckpt": str(encoder),
                 "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "encoder_out_channels": N_UNIT, "f0_extractor": "yin",
                 "f0_min": 65, "f0_max": 800},
        "model": model, "infer": {}})
    return d / "model_5.ckpt"


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    return {"11s": _write_wav(d / "long.wav", 11.0, silences=((5.5, 6.0),)),
            "0.4s": _write_wav(d / "short.wav", 0.4)}


@pytest.fixture(scope="module", params=["CombSubSuperFast", "Sins"])
def ckpt(request, tmp_path_factory, encoder):
    return request.param, _checkpoint(tmp_path_factory.mktemp(request.param),
                                      request.param, encoder)


@pytest.mark.parametrize("wav", ["11s", "0.4s"])
def test_stream_cli_matches_jax(tmp_path, ckpt, wavs, wav):
    mtype, path = ckpt
    outs = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        (tmp_path / name).mkdir()
        argv = ["-m", str(path), "-i", str(wavs[wav]),
                "-o", str(tmp_path / name / "out.wav"), "-k", "2", "-id", "2",
                "--stream", "2"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = wavfile.read(tmp_path / name / "out.wav")
    (sr_j, want), (sr_p, got) = outs["jax"], outs["port"]
    assert sr_p == sr_j == SR
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape
    snr = snr_db(want.astype(np.float64), got.astype(np.float64))
    print(f"{mtype} {wav} --stream 2: SNR vs the JAX CLI {snr:.1f} dB")
    assert snr >= 40.0


def test_stream_cli_repeats_itself(tmp_path, ckpt, wavs):
    """Two runs of the port's ``--stream 2`` on the same segment, each with
    fresh helper ranks, give the same PCM samples."""
    mtype, path = ckpt
    outs = []
    for run in ("first", "second"):
        out = tmp_path / run / "out.wav"
        pcli.main(["-m", str(path), "-i", str(wavs["0.4s"]), "-o", str(out),
                   "-k", "2", "-id", "2", "--stream", "2", "--device", "cpu"])
        outs.append(wavfile.read(out)[1])
    assert outs[0].shape == outs[1].shape and outs[0].size > 0
    np.testing.assert_array_equal(outs[1], outs[0], err_msg=mtype)


def test_stream_with_mix_refused(tmp_path, wavs, encoder):
    """Both CLIs refuse -mix with --stream on a DDSP model, in the same
    words."""
    path = _checkpoint(tmp_path, "CombSubSuperFast", encoder)
    argv = ["-m", str(path), "-i", str(wavs["0.4s"]), "-o",
            str(tmp_path / "out.wav"), "--stream", "2", "-mix",
            "{1: 0.5, 2: 0.5}"]
    with pytest.raises(NotImplementedError) as jerr:
        jcli.main(argv)
    with pytest.raises(NotImplementedError) as perr:
        pcli.main(argv + ["--device", "cpu"])
    assert str(perr.value) == str(jerr.value) == pcli.STREAM_MIX_REFUSED
    assert not Path(tmp_path / "out.wav").exists()
