"""The DIO pitch tracker with StoneMask refinement, on the host (the
port's numpy copy of ddsp_svc_tpu/features/dio.py, equal to it bit for bit).

DIO (Morise et al. 2009): log-spaced low-pass channels over [f0_min,
f0_max]; per channel four period sequences (upward and downward zero
crossings, peaks, dips); per frame the most consistent channel's mean
period, unvoiced where the four disagree or leave the band. StoneMask
(Morise 2010) then refines each voiced frame by the amplitude-weighted
instantaneous frequency of the first two harmonics. The pyworld wheel's
``dio`` + ``stonemask`` take its place when installed
(``features/f0.F0Extractor``).
"""
from __future__ import annotations

import numpy as np


def _lowpass_nuttall(audio: np.ndarray, sample_rate: int, cutoff_hz: float) -> np.ndarray:
    """FFT convolution with a Nuttall-windowed sinc low-pass at cutoff."""
    half = int(round(sample_rate / cutoff_hz * 2.0))
    n = 2 * half + 1
    t = np.arange(n) - half
    x = t * cutoff_hz / sample_rate
    sinc = np.sinc(x)
    m = np.arange(n) / (n - 1)
    nuttall = (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * m)
        + 0.144232 * np.cos(4 * np.pi * m)
        - 0.012604 * np.cos(6 * np.pi * m)
    )
    kern = sinc * nuttall
    kern = kern / kern.sum()
    n_fft = int(2 ** np.ceil(np.log2(len(audio) + n)))
    out = np.fft.irfft(
        np.fft.rfft(audio, n_fft) * np.fft.rfft(kern, n_fft), n_fft
    )
    return out[half : half + len(audio)]


def _event_intervals(sig: np.ndarray, sample_rate: int):
    """(times, intervals) of one event type: seconds of each crossing and
    the local period implied by successive events."""
    pos = sig[:-1] <= 0
    neg = sig[1:] > 0
    idx = np.nonzero(pos & neg)[0]
    if len(idx) < 2:
        return np.zeros(0), np.zeros(0)
    # linear interpolation of the crossing instant
    frac = -sig[idx] / (sig[idx + 1] - sig[idx])
    t_ev = (idx + frac) / sample_rate
    periods = np.diff(t_ev)
    centers = 0.5 * (t_ev[1:] + t_ev[:-1])
    return centers, periods


def _interval_tracks(filtered: np.ndarray, sample_rate: int):
    """Four (centers, period) tracks: up/down zero crossings, peaks, dips."""
    d = np.diff(filtered)
    return [
        _event_intervals(filtered, sample_rate),           # upward zc
        _event_intervals(-filtered, sample_rate),          # downward zc
        _event_intervals(d, sample_rate),                  # peaks
        _event_intervals(-d, sample_rate),                 # dips
    ]


def _sample_track(centers, periods, frame_times):
    """Nearest-event period per frame (0 where no events)."""
    if len(centers) == 0:
        return np.zeros(len(frame_times))
    pos = np.searchsorted(centers, frame_times)
    pos = np.clip(pos, 0, len(centers) - 1)
    left = np.clip(pos - 1, 0, len(centers) - 1)
    use_left = np.abs(frame_times - centers[left]) < np.abs(
        frame_times - centers[pos]
    )
    nearest = np.where(use_left, left, pos)
    return periods[nearest]


def dio_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    channels_in_octave: float = 2.0,
    allowed_deviation: float = 0.1,
) -> np.ndarray:
    """f0 per hop frame (0 unvoiced); len = ceil(len(audio)/hop)."""
    audio = np.asarray(audio, np.float64)
    n_out = int(np.ceil(len(audio) / hop_size)) if len(audio) else 0
    if n_out == 0:
        return np.zeros(0, np.float32)
    frame_times = np.arange(n_out) * hop_size / sample_rate

    if np.abs(audio).max() < 1e-9:
        return np.zeros(n_out, np.float32)

    n_oct = np.log2(f0_max / f0_min)
    n_ch = max(1, int(np.ceil(n_oct * channels_in_octave)) + 1)
    cutoffs = f0_min * 2 ** (np.arange(n_ch) / channels_in_octave)
    cutoffs = cutoffs[cutoffs <= f0_max * 2] if len(cutoffs) else cutoffs

    best_f0 = np.zeros(n_out)
    best_dev = np.full(n_out, np.inf)
    for fc in cutoffs:
        filtered = _lowpass_nuttall(audio, sample_rate, 2.0 * fc)
        tracks = _interval_tracks(filtered, sample_rate)
        per = np.stack(
            [_sample_track(c, p, frame_times) for c, p in tracks]
        )  # (4, T) seconds
        valid = per > 0
        n_valid = valid.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_p = np.where(
                n_valid == 4, per.sum(axis=0) / np.maximum(n_valid, 1), 0.0
            )
            f0_c = np.where(mean_p > 0, 1.0 / np.where(mean_p > 0, mean_p, 1), 0.0)
            dev = np.where(
                mean_p > 0,
                np.sqrt(((per - mean_p) ** 2 * valid).sum(axis=0)
                        / np.maximum(n_valid, 1)) / np.maximum(mean_p, 1e-12),
                np.inf,
            )
        in_band = (f0_c >= f0_min) & (f0_c <= f0_max) & (f0_c <= 1.2 * 2 * fc)
        cand = in_band & (dev < best_dev)
        best_f0 = np.where(cand, f0_c, best_f0)
        best_dev = np.where(cand, dev, best_dev)

    f0 = np.where(best_dev < allowed_deviation, best_f0, 0.0)
    return f0.astype(np.float32)


def stonemask(
    audio: np.ndarray,
    f0: np.ndarray,
    sample_rate: int,
    hop_size: int,
) -> np.ndarray:
    """Refine voiced frames by windowed instantaneous frequency of the first
    two harmonics (pyworld stonemask parity in spirit)."""
    audio = np.asarray(audio, np.float64)
    out = f0.astype(np.float64).copy()
    for i in np.nonzero(f0 > 0)[0]:
        fi = float(f0[i])
        center = i * hop_size
        # 6 periods: narrow enough mainlobe that the harmonic bands are
        # leakage-free (3 periods smears the fundamental into the H2 band)
        half = int(round(3.0 * sample_rate / fi))
        lo, hi = center - half, center + half + 1
        if lo < 0 or hi > len(audio):
            continue
        seg = audio[lo:hi] * np.hanning(hi - lo)
        n_fft = int(2 ** np.ceil(np.log2(len(seg) * 4)))
        spec = np.fft.rfft(seg, n_fft)
        freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
        est, wsum, mag1 = 0.0, 0.0, 0.0
        for h in (1, 2):
            band = (freqs > h * fi * 0.75) & (freqs < h * fi * 1.25)
            if not band.any():
                continue
            mag = np.abs(spec[band])
            if h == 1:
                mag1 = mag.max()
            elif mag.max() < 0.1 * mag1:
                # no real harmonic there — just window leakage of the
                # fundamental; folding it in biases pure tones low
                continue
            k = int(np.argmax(mag))
            # parabolic peak interpolation in the band
            bidx = np.nonzero(band)[0]
            j = bidx[k]
            if 0 < j < len(freqs) - 1:
                ym, y0, yp = np.abs(spec[j - 1]), np.abs(spec[j]), np.abs(spec[j + 1])
                denom = ym - 2 * y0 + yp
                delta = 0.5 * (ym - yp) / denom if abs(denom) > 1e-12 else 0.0
                fpk = freqs[j] + delta * (freqs[1] - freqs[0])
            else:
                fpk = freqs[j]
            w = mag[k]
            est += w * fpk / h
            wsum += w
        if wsum > 0:
            ref = est / wsum
            if abs(np.log2(ref / fi)) < 0.2:  # accept < ~240 cents moves
                out[i] = ref
    return out.astype(np.float32)


def dio_stonemask_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
) -> np.ndarray:
    f0 = dio_f0(audio, sample_rate, hop_size, f0_min, f0_max)
    return stonemask(audio, f0, sample_rate, hop_size)
