"""Offline feature extraction (mirrors ddsp_svc_tpu/data/preprocess.py):
``<root>/audio/**.wav`` -> ``units/ f0/ volume/ [mel/ aug_mel/ aug_vol/]``
``*.npy`` and ``pitch_aug_dict.npy``, files whose f0 is never voiced moved to
``skip/``; the same layout, draws and order as the JAX job.

the volume and a host tracker's f0 run on the host; an f0 net, the units
encoder and the log-mel run on the extractors' own device (the card
unless the caller built them for the CPU). Progress is printed per file.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..features.audio import load_wav
from ..features.f0 import F0Extractor
from ..features.volume import VolumeExtractor
from ..utils.config import traverse_dir


def preprocess(path: str, f0_extractor: F0Extractor,
               volume_extractor: VolumeExtractor, mel_extractor=None,
               units_encoder=None, sample_rate: int = 44100,
               hop_size: int = 512, use_pitch_aug: bool = False,
               extensions: tuple[str, ...] = ("wav",),
               rng: np.random.Generator | None = None,
               skip_existing: bool = False,
               device: str | torch.device = "cpu") -> None:
    """Extract the features of every file under ``path/audio``.
    ``mel_extractor`` (``ops/mel.LogMelSpectrogram``) runs on ``device``;
    ``rng`` draws the gain and key-shift augmentation, as in JAX."""
    rng = rng or np.random.default_rng()
    path_srcdir = os.path.join(path, "audio")
    filelist = traverse_dir(path_srcdir, extensions=list(extensions),
                            is_pure=True, is_sort=True)
    pitch_aug_dict = {}
    aug_dict_path = os.path.join(path, "pitch_aug_dict.npy")
    if skip_existing and os.path.exists(aug_dict_path):
        pitch_aug_dict = dict(np.load(aug_dict_path, allow_pickle=True).item())

    def out_path(kind, file):
        return os.path.join(path, kind, file + ".npy")

    def save(kind, file, arr):
        p = out_path(kind, file)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        np.save(p, arr)

    def mel_of(audio: np.ndarray, keyshift: float = 0.0) -> np.ndarray:
        with torch.no_grad():
            wav = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
            return mel_extractor.extract(wav[None].to(device),
                                         keyshift=keyshift)[0].cpu().numpy()

    for n, file in enumerate(filelist, 1):
        print(f"preprocess {path_srcdir}: {n}/{len(filelist)} {file}", flush=True)
        if skip_existing:
            expected = ["f0", "volume"]
            if units_encoder is not None:
                expected.append("units")
            if mel_extractor is not None:
                expected += ["mel", "aug_mel", "aug_vol"]
            done = all(os.path.exists(out_path(k, file)) for k in expected)
            if done and (mel_extractor is None or file in pitch_aug_dict):
                continue
        audio, sr = load_wav(os.path.join(path_srcdir, file))
        if sr != sample_rate:
            from ..ops.resample import resample

            audio = resample(torch.from_numpy(audio)[None], sr,
                             sample_rate)[0].numpy()

        # f0 first: files destined for skip/ pay no mel or units extraction
        f0 = f0_extractor.extract(audio, uv_interp=False)
        uv = f0 == 0
        if not (~uv).any():
            print(f"\n[Error] F0 extraction failed: {file}")
            skip_dir = os.path.join(path, "skip")
            os.makedirs(skip_dir, exist_ok=True)
            shutil.move(os.path.join(path_srcdir, file), skip_dir)
            continue
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])

        volume = volume_extractor.extract(audio)

        keyshift = 0.0
        if mel_extractor is not None:
            mel = mel_of(audio)
            max_amp = float(np.max(np.abs(audio))) + 1e-5
            max_shift = min(1.0, np.log10(1.0 / max_amp))
            log10_vol_shift = rng.uniform(-1.0, max_shift)
            if use_pitch_aug:
                keyshift = float(rng.uniform(-5.0, 5.0))
            gain = 10.0 ** log10_vol_shift
            aug_mel = mel_of(audio * gain, keyshift)
            aug_vol = volume_extractor.extract(audio * gain)

        if units_encoder is not None:
            with torch.no_grad():
                units = units_encoder.encode(
                    torch.from_numpy(audio)[None], sample_rate, hop_size)
            save("units", file, units[0].cpu().numpy())
        save("f0", file, f0)
        save("volume", file, volume)
        if mel_extractor is not None:
            pitch_aug_dict[file] = keyshift
            save("mel", file, mel)
            save("aug_mel", file, aug_mel)
            save("aug_vol", file, aug_vol)

    if mel_extractor is not None:
        np.save(aug_dict_path, pitch_aug_dict)
