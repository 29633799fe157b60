"""The Harvest pitch tracker, on the host (the port's numpy copy of
ddsp_svc_tpu/features/harvest.py, equal to it bit for bit).

Harvest's structure (Morise 2017): decimate to ~8 kHz; a bank of 24
band-pass channels an octave over [f0_min, f0_max]; per channel four
event-interval tracks, a candidate where they agree, its reliability their
relative deviation; per frame the best few candidates re-scored by the
normalised autocorrelation at their period; a Viterbi pass over candidates
and unvoiced picks the contour; short voiced runs dropped; StoneMask
(features/dio.py) refines on the original-rate audio. The pyworld wheel's
``harvest`` takes its place when installed (``features/f0.F0Extractor``).
"""
from __future__ import annotations

import numpy as np

from .dio import stonemask

_CHANNELS_PER_OCTAVE = 24
_MAX_CANDS = 4
_DEV_LIMIT = 0.2       # discard channel candidates above this deviation
_UV_COST = 0.08        # emission cost of the unvoiced state
_SWITCH_COST = 0.10    # voiced <-> unvoiced transition
_JUMP_WEIGHT = 2.0     # cost per octave of inter-frame movement
_MERGE_CENTS = 50.0
_AC_WEIGHT = 0.5       # weight of (1 - autocorr) in the emission cost


def _ac_score(y: np.ndarray, fs: float, center_s: float, f0: float) -> float:
    """Normalized autocorrelation of y at lag 1/f0 around center_s."""
    lag = int(round(fs / f0))
    win = max(lag * 2, int(0.03 * fs))
    c = int(round(center_s * fs))
    lo = max(0, c - win // 2)
    hi = min(len(y) - lag, lo + win)
    if hi - lo < lag:
        return 0.0
    a = y[lo:hi]
    b = y[lo + lag : hi + lag]
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    if denom <= 1e-12:
        return 0.0
    return float((a * b).sum() / denom)


def _fft_resample(audio: np.ndarray, sr: int, target_sr: int) -> tuple[np.ndarray, int]:
    """Band-limited FFT resample (offline host path)."""
    if sr <= target_sr:
        return audio, sr
    n = len(audio)
    n_new = int(round(n * target_sr / sr))
    spec = np.fft.rfft(audio)
    k = min(len(spec), n_new // 2 + 1)
    out = np.fft.irfft(spec[:k], n_new) * (n_new / n)
    return out, target_sr


def _bandpass(audio_spec: np.ndarray, n_fft: int, fs: float, fc: float,
              n_audio: int) -> np.ndarray:
    """Nuttall-windowed cosine band-pass at fc via spectrum multiply."""
    half = int(round(1.5 * fs / fc))
    n = 2 * half + 1
    t = np.arange(n) - half
    m = np.arange(n) / (n - 1)
    nuttall = (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * m)
        + 0.144232 * np.cos(4 * np.pi * m)
        - 0.012604 * np.cos(6 * np.pi * m)
    )
    kern = np.cos(2 * np.pi * fc * t / fs) * nuttall
    kern = kern / np.abs(kern).sum()
    out = np.fft.irfft(audio_spec * np.fft.rfft(kern, n_fft), n_fft)
    return out[half : half + n_audio]


def _event_track(sig: np.ndarray, fs: float, frame_times: np.ndarray):
    """Linear-interp period (seconds) of one event type on the frame grid;
    NaN outside the observed event range or with <2 events."""
    pos = sig[:-1] <= 0
    neg = sig[1:] > 0
    idx = np.nonzero(pos & neg)[0]
    if len(idx) < 2:
        return np.full(len(frame_times), np.nan)
    frac = -sig[idx] / (sig[idx + 1] - sig[idx])
    t_ev = (idx + frac) / fs
    periods = np.diff(t_ev)
    centers = 0.5 * (t_ev[1:] + t_ev[:-1])
    out = np.interp(frame_times, centers, periods)
    out[(frame_times < centers[0]) | (frame_times > centers[-1])] = np.nan
    return out


def _channel_candidates(filtered: np.ndarray, fs: float,
                        frame_times: np.ndarray):
    """(f0, deviation) per frame from the four interval tracks (NaN where
    any track is missing)."""
    d = np.diff(filtered)
    per = np.stack([
        _event_track(filtered, fs, frame_times),   # upward zc
        _event_track(-filtered, fs, frame_times),  # downward zc
        _event_track(d, fs, frame_times),          # peaks
        _event_track(-d, fs, frame_times),         # dips
    ])
    mean_p = per.mean(axis=0)  # NaN where any missing
    with np.errstate(invalid="ignore", divide="ignore"):
        dev = np.sqrt(((per - mean_p) ** 2).mean(axis=0)) / mean_p
        f0 = 1.0 / mean_p
    return f0, dev


def _merge_frame_candidates(f0s: np.ndarray, devs: np.ndarray):
    """Keep up to _MAX_CANDS distinct (>_MERGE_CENTS apart) best candidates."""
    order = np.argsort(devs)
    kept_f0, kept_dev = [], []
    for j in order:
        if not np.isfinite(devs[j]) or devs[j] >= _DEV_LIMIT:
            break
        f = f0s[j]
        if any(abs(1200 * np.log2(f / k)) < _MERGE_CENTS for k in kept_f0):
            continue
        kept_f0.append(f)
        kept_dev.append(devs[j])
        if len(kept_f0) == _MAX_CANDS:
            break
    return kept_f0, kept_dev


def _viterbi_contour(cands_f0, cands_dev, n_frames: int) -> np.ndarray:
    """DP over per-frame candidate slots + an unvoiced state."""
    f0 = np.zeros((n_frames, _MAX_CANDS))
    cost = np.full((n_frames, _MAX_CANDS + 1), np.inf)
    for t in range(n_frames):
        for s, (f, d) in enumerate(zip(cands_f0[t], cands_dev[t])):
            f0[t, s] = f
            cost[t, s] = d
        cost[t, _MAX_CANDS] = _UV_COST  # unvoiced emission

    total = cost[0].copy()
    back = np.zeros((n_frames, _MAX_CANDS + 1), np.int64)
    for t in range(1, n_frames):
        # transition matrix prev-state x state
        trans = np.full((_MAX_CANDS + 1, _MAX_CANDS + 1), np.inf)
        for s in range(_MAX_CANDS + 1):
            if s < _MAX_CANDS and not np.isfinite(cost[t, s]):
                continue
            for sp in range(_MAX_CANDS + 1):
                if sp < _MAX_CANDS and not np.isfinite(cost[t - 1, sp]):
                    continue
                if s == _MAX_CANDS and sp == _MAX_CANDS:
                    trans[sp, s] = 0.0
                elif s == _MAX_CANDS or sp == _MAX_CANDS:
                    trans[sp, s] = _SWITCH_COST
                else:
                    jump = abs(np.log2(f0[t, s] / f0[t - 1, sp]))
                    trans[sp, s] = _JUMP_WEIGHT * jump
        tot = total[:, None] + trans + cost[t][None, :]
        back[t] = np.argmin(tot, axis=0)
        total = np.min(tot, axis=0)

    path = np.zeros(n_frames, np.int64)
    path[-1] = int(np.argmin(total))
    for t in range(n_frames - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    out = np.zeros(n_frames)
    voiced = path < _MAX_CANDS
    out[voiced] = f0[np.arange(n_frames)[voiced], path[voiced]]
    return out


def _drop_short_runs(f0: np.ndarray, min_frames: int) -> np.ndarray:
    out = f0.copy()
    voiced = f0 > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], voiced.view(np.int8), [0]])))
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < min_frames:
            out[a:b] = 0.0
    return out


def harvest_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
) -> np.ndarray:
    """f0 per hop frame (0 unvoiced); len = ceil(len(audio)/hop)."""
    audio = np.asarray(audio, np.float64)
    n_out = int(np.ceil(len(audio) / hop_size)) if len(audio) else 0
    if n_out == 0:
        return np.zeros(0, np.float32)
    frame_times = np.arange(n_out) * hop_size / sample_rate
    if np.abs(audio).max() < 1e-9:
        return np.zeros(n_out, np.float32)

    target_sr = max(8000, int(np.ceil(f0_max * 4)))
    y, fs = _fft_resample(audio, sample_rate, target_sr)
    n_fft = int(2 ** np.ceil(np.log2(len(y) + int(3 * fs / f0_min) + 2)))
    y_spec = np.fft.rfft(y, n_fft)

    n_ch = int(np.ceil(np.log2(f0_max / f0_min) * _CHANNELS_PER_OCTAVE)) + 1
    centers = f0_min * 2.0 ** (np.arange(n_ch) / _CHANNELS_PER_OCTAVE)

    all_f0 = np.full((n_ch, n_out), np.nan)
    all_dev = np.full((n_ch, n_out), np.inf)
    for i, fc in enumerate(centers):
        filtered = _bandpass(y_spec, n_fft, fs, fc, len(y))
        f0_c, dev_c = _channel_candidates(filtered, fs, frame_times)
        with np.errstate(invalid="ignore"):
            ok = (
                np.isfinite(f0_c) & np.isfinite(dev_c)
                & (f0_c >= f0_min) & (f0_c <= f0_max)
                # a band-passed channel tracks pitch only near its band
                & (f0_c >= fc * 2 ** -0.75) & (f0_c <= fc * 2 ** 0.75)
            )
        all_f0[i, ok] = f0_c[ok]
        all_dev[i, ok] = dev_c[ok]

    cands_f0, cands_dev = [], []
    for t in range(n_out):
        fs_t, ds_t = _merge_frame_candidates(all_f0[:, t], all_dev[:, t])
        # subharmonic hypotheses (missing/weak-fundamental voices have no
        # energy in their own channel); the AC score validates or kills them
        for f, d in list(zip(fs_t, ds_t)):
            sub = f / 2.0
            if sub >= f0_min and not any(
                abs(1200 * np.log2(sub / k)) < _MERGE_CENTS for k in fs_t
            ):
                fs_t = fs_t + [sub]
                ds_t = ds_t + [d + 0.02]
        ds_t = [
            d + _AC_WEIGHT * (1.0 - _ac_score(y, fs, frame_times[t], f))
            for f, d in zip(fs_t, ds_t)
        ]
        order = np.argsort(ds_t)[:_MAX_CANDS]
        cands_f0.append([fs_t[j] for j in order])
        cands_dev.append([ds_t[j] for j in order])

    f0 = _viterbi_contour(cands_f0, cands_dev, n_out)
    min_frames = max(2, int(round(0.03 * sample_rate / hop_size)))
    return _drop_short_runs(f0, min_frames).astype(np.float32)


def harvest_stonemask_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
) -> np.ndarray:
    f0 = harvest_f0(audio, sample_rate, hop_size, f0_min, f0_max)
    return stonemask(audio, f0, sample_rate, hop_size)
