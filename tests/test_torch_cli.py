"""The port's offline CLI (``python -m ddsp_svc_tpu_torch.cli.infer``) against
the JAX package's on the same wav and checkpoint, written by the JAX
package's own ``save_checkpoint`` and ``save_config`` as
tests/test_cli_infer.py writes it, with the tiny units encoder's weights
in an .npz file both CLIs read. This file is the port's CLI smoke; it
stays apart from tests/test_smoke.py, which drives the JAX CLIs.

DDSP checkpoint (CombSubSuperFast with the noise filter's bias at -30, so
the two CLIs' different noise draws do not show): the output wavs agree to
>= 40 dB SNR with the same length and rate, the f0 cache files are byte
for byte the same, and each CLI reads the other's cache. The DiffusionFast
checkpoint's case is tests/test_torch_cli_diffusion.py."""
import subprocess
import sys
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
from ddsp_svc_tpu.train.checkpoint import save_checkpoint
from ddsp_svc_tpu.utils.config import save_config
from torch_helpers import randomize_tree, snr_db

SR, HOP, WIN, N_UNIT = 16000, 64, 256, 256
ROOT = Path(__file__).resolve().parent.parent


def _data(sr, hop, encoder_ckpt):
    return {"sampling_rate": sr, "block_size": hop, "duration": 2,
            "encoder": "tiny", "encoder_ckpt": str(encoder_ckpt),
            "encoder_sample_rate": 16000, "encoder_hop_size": 320,
            "encoder_out_channels": N_UNIT, "f0_extractor": "yin",
            "f0_min": 65, "f0_max": 800}


def _encoder_npz(path):
    variables = {"params": randomize_tree(
        jh.UnitsEncoder("tiny").variables["params"], seed=31)}
    np.savez(path, **flatten(variables))
    return path


@pytest.fixture(scope="module")
def ddsp_ckpt(tmp_path_factory):
    from ddsp_svc_tpu.models.ddsp import CombSubSuperFast

    d = tmp_path_factory.mktemp("ddsp")
    model = CombSubSuperFast(SR, HOP, WIN, n_unit=N_UNIT, n_spk=2)
    params = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, N_UNIT)), 220.0 * jnp.ones((1, 16, 1)),
        jnp.ones((1, 16, 1)), spk_id=jnp.ones((1, 1), jnp.int32)))()["params"])
    bias = np.array(params["unit2ctrl"]["dense_out"]["bias"])
    f_bins = WIN // 2 + 1
    bias[2 * f_bins:3 * f_bins] = -30.0  # exp(-30): the noise filter is off
    params["unit2ctrl"]["dense_out"]["bias"] = bias
    save_checkpoint(str(d), 5, params)
    save_config(d / "config.yaml", {
        "data": _data(SR, HOP, _encoder_npz(d / "encoder.npz")),
        "model": {"type": "CombSubSuperFast", "win_length": WIN, "n_spk": 2},
        "infer": {}})
    return d / "model_5.ckpt"


def _write_wav(path, sr, seconds, silences=()):
    n = np.arange(int(sr * seconds))
    f = 220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * n / sr))
    audio = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr) * np.minimum(1.0, n / 800.0)
    for lo, hi in silences:
        audio[int(lo * sr):int(hi * sr)] = 0.0
    wavfile.write(path, sr, (audio * 32767).astype(np.int16))


def _cache_file(out_dir):
    files = list((out_dir / "cache").glob("*.npy"))
    assert len(files) == 1
    return files[0]


def test_ddsp_cli_matches_jax(tmp_path, ddsp_ckpt, monkeypatch):
    """An 11 s wav with a 0.5 s silence after 5.5 s: two segments, spliced
    by both CLIs."""
    in_wav = tmp_path / "in.wav"
    _write_wav(in_wav, SR, 11.0, silences=((5.5, 6.0),))
    outs = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        (tmp_path / name).mkdir()
        argv = ["-m", str(ddsp_ckpt), "-i", str(in_wav),
                "-o", str(tmp_path / name / "out.wav"), "-k", "2", "-id", "2"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = wavfile.read(tmp_path / name / "out.wav")
    (sr_j, want), (sr_p, got) = outs["jax"], outs["port"]
    assert sr_p == sr_j == SR
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape and len(got) >= 11 * SR - 2 * HOP
    snr = snr_db(want.astype(np.float64), got.astype(np.float64))
    print(f"DDSP CLI output SNR vs the JAX CLI: {snr:.1f} dB")
    assert snr >= 40.0

    cache_j, cache_p = _cache_file(tmp_path / "jax"), _cache_file(tmp_path / "port")
    assert cache_j.name == cache_p.name
    assert cache_j.read_bytes() == cache_p.read_bytes()

    # each CLI reads the other's cache: with its own tracker disabled, a
    # run into the other's output directory reproduces its first output
    def no_tracker(*args, **kwargs):
        raise AssertionError("the f0 cache was not read")

    monkeypatch.setattr(pcli.F0Extractor, "extract", no_tracker)
    pcli.main(["-m", str(ddsp_ckpt), "-i", str(in_wav), "-o",
               str(tmp_path / "jax" / "port.wav"), "-k", "2", "-id", "2",
               "--device", "cpu"])
    assert np.array_equal(wavfile.read(tmp_path / "jax" / "port.wav")[1], got)
    monkeypatch.setattr(jcli.F0Extractor, "extract", no_tracker)
    jcli.main(["-m", str(ddsp_ckpt), "-i", str(in_wav), "-o",
               str(tmp_path / "port" / "jax.wav"), "-k", "2", "-id", "2"])
    assert np.array_equal(wavfile.read(tmp_path / "port" / "jax.wav")[1], want)


@pytest.mark.parametrize("flag", [["-mix", "{1: 0.5, 2: 0.5}"], ["-fs", "3"],
                                  ["-step", "20"], ["--voc_bf16"],
                                  ["--stream", "2"], ["-ddsp", "other.ckpt"]])
def test_cli_refuses_unported_options(flag):
    """No option of the JAX CLI is refused any more: -mix, -fs, -step and
    -ddsp are ported (tests/test_torch_cli_families.py), --voc_bf16 too
    (tests/test_torch_bf16.py) and --stream (tests/test_torch_stream_cli.py).
    What the port refuses is what the JAX CLI refuses: -mix together with
    --stream on a DDSP model, in the JAX CLI's words; the other families
    ignore --stream, as the JAX CLI does."""
    options = pcli.parse_args(["-m", "m", "-i", "i", "-o", "o"] + flag)
    pcli.check_ported(options)
    if flag[0] == "--stream":
        mixed = pcli.parse_args(["-m", "m", "-i", "i", "-o", "o", "-mix",
                                 "{1: 0.5, 2: 0.5}"] + flag)
        with pytest.raises(NotImplementedError, match="streamed engines take "
                           "a single spk_id") as err:
            pcli.check_ported(mixed, "ddsp")
        assert str(err.value) == pcli.STREAM_MIX_REFUSED
        for family in ("diffusion", "reflow", "unit2mel"):
            pcli.check_ported(mixed, family)


def test_cli_help_runs():
    out = subprocess.run([sys.executable, "-m", "ddsp_svc_tpu_torch.cli.infer",
                          "--help"], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("-kstep", "-method", "-speedup", "-pe", "--device"):
        assert flag in out.stdout
