"""``cli.batch_infer``: a nested tree of wavs through one loaded pipeline.

A tiny DiffusionFast checkpoint, its NSF-HiFiGAN and the tiny units
encoder, each converted from a synthetic upstream file by the port's
converter (``torch_convert_helpers``): the outputs mirror the input tree,
and each equals ``SvcPipeline.infer`` on that file alone with the seed
the batch gave it, bit for bit (the PCM16 files). One file also holds
against the JAX package's ``cli.batch_infer`` on the DDSP checkpoint of
tests/test_torch_cli.py (the noise filter off, so the two packages'
different draws do not show): >= 40 dB, that file's tolerance.
"""
import json

import numpy as np
import pytest
from scipy.io import wavfile

import torch_convert_helpers as up
from ddsp_svc_tpu.utils.config import load_config as jax_load_config
from ddsp_svc_tpu.utils.config import save_config
from ddsp_svc_tpu_torch.cli import batch_infer
from ddsp_svc_tpu_torch.convert.__main__ import main as convert_main
from ddsp_svc_tpu_torch.features.audio import load_wav
from ddsp_svc_tpu_torch.features.hubert import ENCODER_CONFIGS
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from test_torch_cli import SR as DDSP_SR
from test_torch_cli import _write_wav, ddsp_ckpt  # noqa: F401 (a fixture)
from torch_helpers import snr_db

SR, HOP = 16000, 64
TREE = {"a.wav": (0.4, 22050), "sub/b.wav": (0.6, 16000),
        "sub/deeper/c.wav": (0.3, 44100)}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    cfg = ENCODER_CONFIGS["tiny"]
    up.save_upstream(d / "hubert.pt", up.hubert_state_dict(
        "bshall", cfg.dim, cfg.ffn_dim, cfg.num_layers, seed=1,
        proj_dim=cfg.proj_dim), None)
    convert_main(["hubert", str(d / "hubert.pt"), "tiny", str(d / "hubert.msgpack")])
    voc = dict(sampling_rate=SR, num_mels=128, n_fft=256, win_size=256,
               hop_size=HOP, fmin=40, fmax=8000, upsample_rates=[4, 4, 4],
               upsample_kernel_sizes=[8, 8, 8], upsample_initial_channel=32,
               resblock="1", resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]])
    (d / "vocoder").mkdir()
    (d / "vocoder" / "config.json").write_text(json.dumps(voc))
    up.save_upstream(d / "vocoder" / "model", up.nsf_hifigan_state_dict(voc, seed=2),
                     "generator")
    convert_main(["nsf-hifigan", str(d / "vocoder" / "model")])
    save_config(d / "config.yaml", {
        "data": {"sampling_rate": SR, "block_size": HOP, "duration": 2,
                 "encoder": "tiny", "encoder_ckpt": str(d / "hubert.msgpack"),
                 "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "encoder_out_channels": cfg.proj_dim, "f0_extractor": "yin",
                 "f0_min": 65, "f0_max": 800},
        "model": {"type": "DiffusionFast", "win_length": 256, "n_spk": 1,
                  "n_layers": 2, "n_chans": 16, "k_step_max": 10},
        "vocoder": {"type": "nsf-hifigan", "ckpt": str(d / "vocoder" / "model")}})
    args = jax_load_config(str(d / "config.yaml"))
    up.save_upstream(d / "model_3.pt", up.model_state_dict(args, seed=3), "model")
    convert_main(["model", str(d / "model_3.pt"), str(d / "config.yaml"), str(d)])
    inp = d / "in"
    for rel, (seconds, sr) in TREE.items():
        (inp / rel).parent.mkdir(parents=True, exist_ok=True)
        _write_wav(inp / rel, sr, seconds)
    (inp / "notes.txt").write_text("not a wav")
    return d


def test_outputs_mirror_the_tree_and_equal_solo_requests(model_dir, tmp_path):
    out = tmp_path / "out"
    files = batch_infer.main(["-m", str(model_dir / "model_3.ckpt"), "-i",
                              str(model_dir / "in"), "-o", str(out), "-kstep",
                              "10", "--device", "cpu"])
    assert files == sorted(TREE)
    written = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    assert written == sorted(TREE)
    solo = SvcPipeline(str(model_dir / "model_3.ckpt"), device="cpu")
    seeds = np.random.default_rng(0)  # the batch pipeline's sequence
    for rel in files:
        audio, sr = load_wav(str(model_dir / "in" / rel))
        want, want_sr = solo.infer(audio, sr, k_step=10,
                                   seed=int(seeds.integers(1 << 62)))
        got_sr, got = wavfile.read(out / rel)
        assert got_sr == want_sr == SR
        expect = np.clip(np.round(want * 32767.0), -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(got, expect, err_msg=rel)
        assert np.abs(got).max() > 0


def test_one_file_matches_the_jax_cli(ddsp_ckpt, tmp_path):  # noqa: F811
    from ddsp_svc_tpu.cli import batch_infer as jax_batch_infer

    (tmp_path / "in" / "x").mkdir(parents=True)
    _write_wav(tmp_path / "in" / "x" / "song.wav", DDSP_SR, 2.0)
    for name, run, extra in (("jax", jax_batch_infer.main, []),
                             ("port", batch_infer.main, ["--device", "cpu"])):
        run(["-m", str(ddsp_ckpt), "-i", str(tmp_path / "in"), "-o",
             str(tmp_path / name), "-k", "2"] + extra)
    sr_j, want = wavfile.read(tmp_path / "jax" / "x" / "song.wav")
    sr_p, got = wavfile.read(tmp_path / "port" / "x" / "song.wav")
    assert sr_p == sr_j and got.shape == want.shape
    assert snr_db(want.astype(np.float64), got.astype(np.float64)) >= 40.0


def test_batch_infer_defaults_to_the_card(monkeypatch, model_dir, tmp_path):
    import torch

    assert batch_infer.parse_args(["-m", "m", "-i", "i", "-o", "o"]).device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_infer.main(["-m", str(model_dir / "model_3.ckpt"), "-i",
                          str(model_dir / "in"), "-o", str(tmp_path)])
    assert not any(tmp_path.iterdir())
