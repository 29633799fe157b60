"""Boersma's (1993) autocorrelation pitch tracker, praat's ``to_pitch_ac``,
on the host (the port's numpy copy of ddsp_svc_tpu/features/praat.py, equal
to it bit for bit).

Frames of 3 / f0_min seconds, Hanning-windowed, mean removed; each frame's
normalised autocorrelation divided by the window's own; local maxima in
[f0_min, f0_max] with parabolic interpolation as candidates, plus an
unvoiced candidate (Boersma eq. 23); a Viterbi pass with octave-jump and
voicing costs. The parselmouth wheel takes its place for 'parselmouth'
when installed (``features/f0.F0Extractor``).
"""
from __future__ import annotations

import numpy as np

# praat defaults (pitch_ac documentation / Boersma 1993 table 1)
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14
MAX_CANDIDATES = 15


def praat_ac_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    voicing_threshold: float = 0.6,
) -> np.ndarray:
    """f0 per hop frame (0 where unvoiced); len = ceil(len(audio)/hop)."""
    audio = np.asarray(audio, np.float64)
    n_out = int(np.ceil(len(audio) / hop_size)) if len(audio) else 0
    if n_out == 0:
        return np.zeros(0, np.float32)

    # ---- 1. framing ------------------------------------------------------
    win_len = int(round(3.0 / f0_min * sample_rate))
    win_len += win_len % 2  # even
    half = win_len // 2
    padded = np.pad(audio, (half, half + hop_size))
    starts = np.arange(n_out) * hop_size
    idx = starts[:, None] + np.arange(win_len)[None, :]
    frames = padded[idx]  # (T, W), centered on each hop point
    frames = frames - frames.mean(axis=1, keepdims=True)

    global_peak = np.abs(audio).max() + 1e-12
    local_peak = np.abs(frames).max(axis=1) + 1e-12

    window = np.hanning(win_len)
    fw = frames * window

    # ---- 2. normalized ACF with lag-window correction --------------------
    n_fft = int(2 ** np.ceil(np.log2(2 * win_len)))
    spec = np.fft.rfft(fw, n_fft, axis=1)
    acf = np.fft.irfft(spec * np.conj(spec), n_fft, axis=1)[:, :win_len]
    acf0 = acf[:, :1].copy()
    acf0[acf0 <= 0] = 1e-12
    r = acf / acf0
    w_spec = np.fft.rfft(window, n_fft)
    w_acf = np.fft.irfft(w_spec * np.conj(w_spec), n_fft)[:win_len]
    w_acf = w_acf / w_acf[0]
    w_acf[w_acf < 1e-6] = 1e-6
    r = r / w_acf[None, :]  # (T, W) r[:,0] == 1

    # ---- 3. candidates ---------------------------------------------------
    lag_min = max(2, int(np.floor(sample_rate / f0_max)))
    lag_max = min(win_len - 2, int(np.ceil(sample_rate / f0_min)))
    lags = np.arange(lag_min, lag_max)
    seg = r[:, lag_min:lag_max]
    is_peak = (
        (seg > np.concatenate([r[:, lag_min - 1 : lag_min], seg[:, :-1]], 1))
        & (seg >= seg_right(r, lag_min, lag_max))
    )
    t_frames = frames.shape[0]
    cand_f = np.zeros((t_frames, MAX_CANDIDATES), np.float64)
    cand_s = np.full((t_frames, MAX_CANDIDATES), -1e9, np.float64)
    # unvoiced candidate strength (Boersma eq. 23)
    cand_f[:, 0] = 0.0
    cand_s[:, 0] = voicing_threshold + np.maximum(
        0.0,
        2.0
        - (local_peak / global_peak)
        / (SILENCE_THRESHOLD / (1.0 + voicing_threshold)),
    )
    for ti in range(t_frames):
        pk = np.nonzero(is_peak[ti])[0]
        if pk.size == 0:
            continue
        # parabolic interpolation around each peak
        tau = lags[pk].astype(np.float64)
        ym = r[ti, lags[pk] - 1]
        y0 = r[ti, lags[pk]]
        yp = r[ti, lags[pk] + 1]
        denom = ym - 2 * y0 + yp
        delta = np.where(np.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
        delta = np.clip(delta, -1.0, 1.0)
        tau_i = tau + delta
        s_i = y0 - 0.25 * (ym - yp) * delta
        freq = sample_rate / tau_i
        ok = (freq >= f0_min) & (freq <= f0_max)
        freq, s_i = freq[ok], s_i[ok]
        # strength with high-frequency preference (octave cost)
        s_i = s_i - OCTAVE_COST * np.log2(f0_min / freq)
        order = np.argsort(s_i)[::-1][: MAX_CANDIDATES - 1]
        k = len(order)
        cand_f[ti, 1 : 1 + k] = freq[order]
        cand_s[ti, 1 : 1 + k] = s_i[order]

    # ---- 4. Viterbi ------------------------------------------------------
    trans_cost = np.zeros((MAX_CANDIDATES, MAX_CANDIDATES), np.float64)
    best_prev = np.zeros((t_frames, MAX_CANDIDATES), np.int64)
    score = cand_s[0].copy()
    for ti in range(1, t_frames):
        fp = cand_f[ti - 1]
        fc = cand_f[ti]
        vp = fp > 0
        vc = fc > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            jump = np.abs(np.log2(fp[:, None] / fc[None, :]))
        trans_cost = np.where(
            vp[:, None] & vc[None, :],
            OCTAVE_JUMP_COST * jump,
            np.where(vp[:, None] ^ vc[None, :], VOICED_UNVOICED_COST, 0.0),
        )
        total = score[:, None] - trans_cost
        best_prev[ti] = np.argmax(total, axis=0)
        score = total[best_prev[ti], np.arange(MAX_CANDIDATES)] + cand_s[ti]

    path = np.zeros(t_frames, np.int64)
    path[-1] = int(np.argmax(score))
    for ti in range(t_frames - 1, 0, -1):
        path[ti - 1] = best_prev[ti, path[ti]]
    f0 = cand_f[np.arange(t_frames), path]
    return f0.astype(np.float32)


def seg_right(r: np.ndarray, lag_min: int, lag_max: int) -> np.ndarray:
    """r shifted one lag right over the candidate band (peak test helper)."""
    return r[:, lag_min + 1 : lag_max + 1]
