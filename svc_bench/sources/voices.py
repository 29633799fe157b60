"""Synthetic voices: each request a sine with vibrato and tremolo at its
pitch, light noise, and a stretch of exact silence in its middle (upstream
chip smoke's ``voice_wave``), with a length and a pitch from the mix's
distributions and a noise seed of its own. The mix gives ``"pool"``,
``"length_s"``, ``"pitch_hz"`` and ``"voice"``."""
from __future__ import annotations

import numpy as np

from svc_bench.generator import Request, quantiles


def voice(seconds: float, pitch: float, v: dict, sample_rate: int,
          rng: np.random.Generator) -> np.ndarray:
    n = int(seconds * sample_rate)
    ts = np.arange(n) / sample_rate
    f0 = pitch * 2.0 ** (v["vibrato_semitones"] / 12.0
                         * np.sin(2 * np.pi * v["vibrato_hz"] * ts))
    wave = v["amplitude"] * np.sin(2 * np.pi * np.cumsum(f0) / sample_rate) * (
        1.0 - v["tremolo_depth"] + v["tremolo_depth"]
        * np.sin(2 * np.pi * v["tremolo_hz"] * ts))
    wave += v["noise"] * rng.standard_normal(n)
    half = int(v["silence_s"] * sample_rate / 2)
    wave[n // 2 - half: n // 2 + half] = 0.0
    return wave.astype(np.float32)


def make(mix: dict, seed: int, sample_rate: int) -> list[Request]:
    """The run's requests in the order the driver sends them (cycling)."""
    rng = np.random.default_rng(int(seed))
    n = int(mix["pool"])
    lengths = rng.permutation(quantiles(mix["length_s"], n))
    pitches = rng.permutation(quantiles(mix["pitch_hz"], n))
    seeds = rng.integers(1, 1 << 62, size=n)
    return [Request(i, voice(float(s), float(p), mix["voice"], sample_rate, rng),
                    int(k), float(p))
            for i, (s, p, k) in enumerate(zip(lengths, pitches, seeds))]
