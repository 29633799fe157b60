"""Dependency-free wav I/O (the port's own copy of
ddsp_svc_tpu/features/audio.py: ``load_wav``, ``to_mono``, ``save_wav``;
host numpy and scipy).

Reads PCM16/24/32, uint8 and float RIFF wavs (scipy returns PCM24 as
int32), mixes down to mono, and writes PCM16 or float32.
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def load_wav(path: str, mono: bool = True) -> tuple[np.ndarray, int]:
    """Read a wav; returns (float32 audio in [-1,1], sample_rate).

    Shape: (L,) if mono else (L, C).
    """
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32 / float64
        audio = data.astype(np.float32)
    if mono:
        audio = to_mono(audio)
    return audio, int(sr)


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim > 1:
        return audio.mean(axis=-1)
    return audio


def save_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    audio = np.asarray(audio)
    if subtype == "PCM_16":
        data = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)
    elif subtype == "FLOAT":
        data = audio.astype(np.float32)
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    wavfile.write(path, sr, data)
