"""The port's C++ batch prefetcher (``data/_prefetch.cpp`` through
``data/prefetch.py``) against the port's ``BatchSampler`` and the JAX
package's ``PrefetchBatchSampler``, on PCM16 and float32 corpora:

  - every batch bit for bit equal to the port's BatchSampler, cached and
    uncached, with the same seed; and to JAX's prefetcher, bit for bit but
    for the gained audio and volume, within 1 ulp: JAX's multiplies by its
    gain as a numpy float64 and rounds once, BatchSampler (both packages')
    by a Python float, in float32, and the port's prefetcher does as
    BatchSampler does;
  - ``npy_index`` and ``wav_index`` read what numpy and the wav loader
    read; the slots rotate (more slots than two, and several rotations);
  - the library lands under ``build/prefetch/`` at the repository root;
  - the solver takes the prefetcher for an uncached corpus without mels
    (the JAX solver's condition) and ``BatchSampler`` otherwise, and
    ``cli.train`` trains through it on batches equal to BatchSampler's.
"""
import os
from pathlib import Path

import numpy as np
import pytest

import torch_helpers  # noqa: F401 (torch's threads under xdist)
from ddsp_svc_tpu.data.dataset import AudioDataset as JAudioDataset
from ddsp_svc_tpu.data.prefetch import PrefetchBatchSampler as JPrefetch
from ddsp_svc_tpu_torch.data import prefetch
from ddsp_svc_tpu_torch.data.dataset import AudioDataset, BatchSampler
from ddsp_svc_tpu_torch.data.prefetch import PrefetchBatchSampler
from ddsp_svc_tpu_torch.features.audio import load_wav, save_wav
from ddsp_svc_tpu_torch.train import solver
from ddsp_svc_tpu_torch.utils.config import DotDict, save_config
from torch_train_helpers import tiny_config

ROOT = Path(__file__).resolve().parent.parent
SR, HOP, N_UNIT = 16000, 160, 8
SEC = 0.5  # crop length


def write_corpus(root: Path, subtype: str, sr: int = SR, hop: int = HOP,
                 n_unit: int = N_UNIT, seed: int = 0) -> str:
    """Three speakers' files of 1.2-2 s: audio, units, f0, volume."""
    rng = np.random.default_rng(seed)
    for spk, name in ((1, "a"), (2, "b"), (1, "c")):
        n = int(rng.uniform(1.2, 2.0) * sr)
        n_frames = n // hop + 1
        audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / sr)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        (root / "audio" / str(spk)).mkdir(parents=True, exist_ok=True)
        save_wav(str(root / "audio" / str(spk) / f"{name}.wav"), audio, sr, subtype)
        for kind, arr in (("units", rng.standard_normal((n_frames, n_unit))),
                          ("f0", 220.0 + 20.0 * rng.random(n_frames)),
                          ("volume", 0.3 * rng.random(n_frames))):
            (root / kind / str(spk)).mkdir(parents=True, exist_ok=True)
            np.save(str(root / kind / str(spk) / f"{name}.wav.npy"),
                    arr.astype(np.float32))
    return str(root)


@pytest.fixture(scope="module", params=["PCM_16", "FLOAT"], ids=["pcm16", "f32"])
def corpus(request, tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp(request.param), request.param)


def _dataset(root, cached, cls=AudioDataset):
    return cls(root, waveform_sec=SEC, hop_size=HOP, sample_rate=SR,
               load_all_data=cached, n_spk=2, use_aug=True)


def test_batches_bit_for_bit(corpus):
    samplers = {"cached": BatchSampler(_dataset(corpus, True), 4, seed=7),
                "uncached": BatchSampler(_dataset(corpus, False), 4, seed=7),
                "jax prefetch": JPrefetch(_dataset(corpus, False, JAudioDataset),
                                          batch_size=4, seed=7)}
    pf = PrefetchBatchSampler(_dataset(corpus, False), batch_size=4, seed=7)
    try:
        for _ in range(5):
            got = pf.sample()
            for name, s in samplers.items():
                want = s.sample()
                assert set(got) == set(want), name
                for k in want:
                    assert got[k].dtype == want[k].dtype, (name, k)
                    if name == "jax prefetch" and k in ("audio", "volume"):
                        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=1)
                    else:
                        np.testing.assert_array_equal(got[k], want[k],
                                                      err_msg=f"{name} {k}")
            assert not np.array_equal(got["audio"][0], got["audio"][1])
    finally:
        pf.close()
        samplers["jax prefetch"].close()


def test_wav_index(corpus):
    path = os.path.join(corpus, "audio", "1", "a.wav")
    off, n, kind, rate = prefetch.wav_index(path)
    audio, sr = load_wav(path)
    assert rate == sr == SR and n == len(audio)
    if kind == "pcm16":
        raw = np.fromfile(path, np.int16, count=n, offset=off) / np.float32(32768.0)
    else:
        assert kind == "f32"
        raw = np.fromfile(path, np.float32, count=n, offset=off)
    np.testing.assert_array_equal(raw.astype(np.float32), audio)


def test_npy_index(corpus):
    path = os.path.join(corpus, "units", "1", "a.wav.npy")
    off, shape, descr = prefetch.npy_index(path)
    arr = np.load(path)
    assert shape == arr.shape and descr == "<f4"
    raw = np.fromfile(path, np.float32, offset=off).reshape(shape)
    np.testing.assert_array_equal(raw, arr)
    with pytest.raises(ValueError, match="not a .npy"):
        prefetch.npy_index(os.path.join(corpus, "audio", "1", "a.wav"))


def test_slots_rotate(corpus):
    pf = PrefetchBatchSampler(_dataset(corpus, False), batch_size=2, seed=1)
    ref = BatchSampler(_dataset(corpus, True), 2, seed=1)
    try:
        assert pf._inflight == list(range(prefetch.N_SLOTS)) == [0, 1]
        drained, seen = [], []
        for _ in range(7):  # > 3 full rotations
            drained.append(pf._inflight[0])
            seen.append(pf.sample())
            assert sorted(pf._inflight) == [0, 1]  # both slots stay in flight
        assert drained == [0, 1, 0, 1, 0, 1, 0]
        assert len({s["audio"].tobytes() for s in seen}) == 7
        for got in seen:
            np.testing.assert_array_equal(got["audio"], ref.sample()["audio"])
    finally:
        pf.close()


def test_library_builds_under_build(corpus):
    PrefetchBatchSampler(_dataset(corpus, False), batch_size=1).close()
    lib = prefetch.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "prefetch"
    assert lib.name.startswith("libddsp_prefetch_") and lib.suffix == ".so"
    assert not (Path(prefetch.__file__).parent / "_prefetch.so").exists()
    assert prefetch.build() == lib  # reused, not rebuilt


def _args(cache_all_data: bool, mtype: str = "CombSubSuperFast"):
    return DotDict({"train": {"batch_size": 2, "cache_all_data": cache_all_data},
                    "model": {"type": mtype}})


def test_solver_picks_the_prefetcher_as_jax_does(corpus):
    uncached = _dataset(corpus, False)
    pf = solver.make_sampler(_args(False), uncached, seed=3)
    try:
        assert isinstance(pf, PrefetchBatchSampler) and pf.batch_size == 2
    finally:
        pf.close()
    cached = solver.make_sampler(_args(True), _dataset(corpus, True), seed=3)
    assert type(cached) is BatchSampler
    uncached.with_mel = True  # a diffusion corpus: the prefetcher refuses mels
    assert type(solver.make_sampler(_args(False, "DiffusionFast"), uncached, 3)) \
        is BatchSampler
    with pytest.raises(NotImplementedError, match="ddsp-family"):
        PrefetchBatchSampler(uncached, 2)


def test_cli_train_through_the_prefetcher(tmp_path, monkeypatch):
    """Two CombSubSuperFast steps of cli.train on an uncached corpus: every
    batch comes from the prefetcher and equals BatchSampler's."""
    from ddsp_svc_tpu_torch.cli import train as ptrain

    root = write_corpus(tmp_path / "data", "PCM_16", sr=44100, hop=512, n_unit=32)
    args = tiny_config("CombSubSuperFast", batch_size=2, cache_all_data=False,
                       interval_log=1, interval_val=1000, interval_force_save=0,
                       epochs=100000, amp_dtype="fp32")
    args["data"].update(train_path=root, valid_path=root)
    args["env"]["expdir"] = str(tmp_path / "exp")
    save_config(tmp_path / "config.yaml", args)
    batches = []
    sample = PrefetchBatchSampler.sample

    def recording(self):
        batches.append(sample(self))
        return batches[-1]

    monkeypatch.setattr(PrefetchBatchSampler, "sample", recording)
    ptrain.main(["-c", str(tmp_path / "config.yaml"), "--device", "cpu",
                 "--max_steps", "2"])
    assert len(batches) >= 2
    ref = BatchSampler(AudioDataset(root, 0.5, 512, 44100, load_all_data=True,
                                    use_aug=True), 2, seed=0)
    for got in batches:
        want = ref.sample()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
