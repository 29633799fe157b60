"""The training data path against the JAX package: ``BatchSampler`` batches
bit for bit on a synthetic corpus (with and without mel, cached and not,
with the gain and key-shift augmentations), the preprocess job's outputs
(f0 and volume exactly, units and mel at 1e-5 with the same encoder
parameters and the same augmentation draws), and ``cli.draw``."""
import os

import numpy as np
import pytest
from scipy.io import wavfile

import ddsp_svc_tpu.cli.draw as jdraw
import ddsp_svc_tpu.data.dataset as jds
import ddsp_svc_tpu.features.hubert as jh
from ddsp_svc_tpu.cli.common import build_mel_extractor as jax_mel
from ddsp_svc_tpu.data.preprocess import preprocess as jax_preprocess
from ddsp_svc_tpu.features.f0 import F0Extractor as JF0
from ddsp_svc_tpu.features.volume import VolumeExtractor as JVol
from ddsp_svc_tpu_torch.cli import draw as pdraw
from ddsp_svc_tpu_torch.cli.common import build_mel_extractor as port_mel
from ddsp_svc_tpu_torch.data import dataset as pds
from ddsp_svc_tpu_torch.data.preprocess import preprocess as port_preprocess
from ddsp_svc_tpu_torch.features.f0 import F0Extractor as PF0
from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder as PUnits
from ddsp_svc_tpu_torch.features.volume import VolumeExtractor as PVol
from torch_helpers import randomize_tree
from torch_train_helpers import tiny_config

SR, HOP = 44100, 512


def _voice(seconds, rng, f0=220.0):
    n = np.arange(int(SR * seconds))
    f = f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * n / SR))
    a = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / SR) + 0.01 * rng.standard_normal(len(n))
    return (a * 32767).astype(np.int16)


def _write_corpus(root, seconds, seed=0):
    rng = np.random.default_rng(seed)
    for i, sec in enumerate(seconds):
        spk = 1 + i % 2
        path = os.path.join(root, "audio", f"{spk}_spk", f"f{i}.wav")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wavfile.write(path, SR, _voice(sec, rng, 180.0 + 20 * i))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Wavs of 0.4-1.3 s (one too short for a 0.5 s crop) with synthetic
    features and a pitch_aug_dict, as preprocess lays them out."""
    root = str(tmp_path_factory.mktemp("corpus"))
    seconds = (1.3, 0.9, 0.4, 1.1, 0.8)
    _write_corpus(root, seconds)
    rng = np.random.default_rng(1)
    aug = {}
    for i, sec in enumerate(seconds):
        name = f"{1 + i % 2}_spk/f{i}.wav"
        n = int(SR * sec) // HOP + 1
        feats = {"f0": rng.uniform(100, 300, n), "volume": rng.uniform(0, .3, n),
                 "units": rng.standard_normal((n, 16)), "mel": rng.standard_normal((n, 8)),
                 "aug_mel": rng.standard_normal((n, 8)), "aug_vol": rng.uniform(0, .3, n)}
        for kind, arr in feats.items():
            p = os.path.join(root, kind, name + ".npy")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            np.save(p, arr.astype(np.float32))
        aug[name] = float(rng.uniform(-5, 5))
    np.save(os.path.join(root, "pitch_aug_dict.npy"), aug)
    return root


@pytest.mark.parametrize("with_mel,cached,n_spk", [(False, True, 1), (False, False, 2),
                                                   (True, True, 2), (True, False, 1)])
def test_batches_bit_identical(corpus, with_mel, cached, n_spk):
    kw = dict(waveform_sec=0.5, hop_size=HOP, sample_rate=SR, load_all_data=cached,
              use_aug=True, with_mel=with_mel, n_spk=n_spk)
    samplers = [mod.BatchSampler(mod.AudioDataset(corpus, **kw), 3, seed=7)
                for mod in (jds, pds)]
    assert samplers[0].files == samplers[1].files and len(samplers[1].files) == 4
    for _ in range(6):
        want, got = (s.sample() for s in samplers)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "aug_shift" in want if with_mel else "audio" in want


def test_get_datasets(corpus):
    args = tiny_config("DiffusionFast", cache_all_data=True)
    args["data"].update(train_path=corpus, valid_path=corpus, duration=0.5)
    (jt, jv), (pt, pv) = jds.get_datasets(args), pds.get_datasets(args)
    assert jt.paths == pt.paths and jv.paths == pv.paths
    assert jv.whole_audio and pv.whole_audio and pt.with_mel
    rng_j, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    for name in jv.paths:
        a, b = jv.sample_crop(name, rng_j), pv.sample_crop(name, rng_p)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_preprocess_outputs(tmp_path):
    """Both jobs on two wavs with YIN, the tiny units encoder on the same
    parameters, the log-mel and pitch augmentation from the same draws."""
    args = tiny_config("DiffusionFast")
    variables = {"params": randomize_tree(jh.UnitsEncoder("tiny").variables["params"],
                                          seed=3)}
    encoders = {"jax": jh.UnitsEncoder("tiny", params=variables),
                "port": PUnits("tiny", params=variables, device="cpu")}
    for name, fn, f0, vol, mel in (
            ("jax", jax_preprocess, JF0("yin", sample_rate=SR, hop_size=HOP,
                                        f0_min=65, f0_max=800), JVol(HOP), jax_mel(args)),
            ("port", port_preprocess, PF0("yin", sample_rate=SR, hop_size=HOP,
                                          f0_min=65, f0_max=800), PVol(HOP),
             port_mel(args))):
        root = str(tmp_path / name)
        _write_corpus(root, (0.6, 0.45), seed=4)
        kw = {"device": "cpu"} if name == "port" else {}
        fn(root, f0, vol, mel, encoders[name], sample_rate=SR, hop_size=HOP,
           use_pitch_aug=True, rng=np.random.default_rng(5), **kw)
    j, p = str(tmp_path / "jax"), str(tmp_path / "port")
    files = sorted(os.path.relpath(os.path.join(d, f), j) for d, _, fs in os.walk(j)
                   for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), p)
                           for d, _, fs in os.walk(p) for f in fs)
    for rel in files:
        if not rel.endswith(".npy"):
            continue
        a = np.load(os.path.join(j, rel), allow_pickle=True)
        b = np.load(os.path.join(p, rel), allow_pickle=True)
        if rel == "pitch_aug_dict.npy":
            assert a.item() == b.item()
        elif rel.split(os.sep)[0] in ("f0", "volume", "aug_vol"):
            np.testing.assert_array_equal(b, a, err_msg=rel)
        else:
            assert a.shape == b.shape, rel
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), rel


def test_draw_moves_the_same_files(tmp_path, monkeypatch):
    for name in ("jax", "port"):
        _write_corpus(str(tmp_path / name / "train"), (2.5, 1.0, 3.0, 2.2, 4.0))
    real = np.random.default_rng
    for name, main in (("jax", jdraw.main), ("port", pdraw.main)):
        monkeypatch.setattr(np.random, "default_rng", lambda *a: real(9))
        main(["--train", str(tmp_path / name / "train"), "--val",
              str(tmp_path / name / "val"), "-n", "2", "--min-sec", "2"])
        monkeypatch.setattr(np.random, "default_rng", real)
    moved = [sorted(os.path.relpath(os.path.join(d, f), tmp_path / n / "val")
                    for d, _, fs in os.walk(tmp_path / n / "val") for f in fs)
             for n in ("jax", "port")]
    assert moved[0] == moved[1] and len(moved[0]) == 2
