"""The f0 front-end's YIN path (the port's own copy of
ddsp_svc_tpu/features/f0.py: ``decimation_filter``, ``_decimate_fir``,
``_interp_unvoiced``, ``yin_f0`` and ``F0Extractor``; host numpy, as in the
JAX package).

'yin' is the built-in vectorised YIN (de Cheveigne & Kawahara 2002) on the
synth hop grid. The f0 nets ('rmvpe', 'crepe', 'fcpe') need converted
weights: without them the extractor prints the JAX package's warning and
falls back to YIN, as the JAX package does; with them it raises, since the
nets are not ported yet (ROADMAP A item 5), nor are the host trackers
('parselmouth', 'praat', 'dio', 'harvest').

All paths share the framing contract: n_frames = len // hop + 1,
``silence_front`` frame skipping, optional unvoiced interpolation and the
``f0_min`` floor.
"""
from __future__ import annotations

import os

import numpy as np

_NOT_PORTED = ("is not ported yet (ROADMAP A item 5: the f0 nets and host "
               "trackers); use 'yin'")
# converted weights the JAX package's F0Extractor looks for by default
_DEFAULT_WEIGHTS = {
    "rmvpe": "pretrain/rmvpe/model.msgpack",
    "crepe": "pretrain/crepe/full.msgpack",
    "fcpe": "pretrain/fcpe/fcpe.msgpack",
}


def decimation_filter(factor: int) -> np.ndarray:
    """Windowed-sinc low-pass taps for polyphase decimation by ``factor``
    (Kaiser beta=9, cutoff 0.92 of the decimated Nyquist, 32*factor+1 taps,
    unit DC gain). Shared by the host YIN (``yin_f0``) and the device YIN
    (features/yin_device.py) so the two stay numerically identical:
    designed on the host in f64, applied in f32 by both."""
    taps = 32 * factor + 1
    cutoff = 0.92 * 0.5 / factor  # cycles/sample at the ORIGINAL rate
    t = np.arange(taps, dtype=np.float64) - (taps - 1) / 2
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * t) * np.kaiser(taps, 9.0)
    return (h / h.sum()).astype(np.float32)


def _decimate_fir(audio: np.ndarray, factor: int) -> np.ndarray:
    """Polyphase FIR decimation: y[m] = sum_t h[t] x[m*factor + t - T//2]
    (zero-padded edges), n_out = len(audio)//factor — the host half of the
    shared-decimator contract above."""
    h = decimation_filter(factor)
    half = len(h) // 2
    x = np.pad(np.asarray(audio, np.float32), (half, half))
    n_out = len(audio) // factor
    windows = np.lib.stride_tricks.sliding_window_view(x, len(h))[
        : n_out * factor : factor
    ]
    return windows @ h


def _interp_unvoiced(f0: np.ndarray) -> np.ndarray:
    uv = f0 == 0
    if (~uv).any():
        f0 = f0.copy()
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0


def yin_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_size: int,
    f0_min: float = 65.0,
    f0_max: float = 800.0,
    threshold: float = 0.1,
    voicing_threshold: float = 0.35,
    decimate: bool = True,
) -> np.ndarray:
    """Vectorized YIN pitch tracker on the hop grid.

    Returns (n_frames,) f0 in Hz with 0 for unvoiced,
    n_frames = len(audio)//hop + 1.

    ``decimate`` halves the analysis rate while tau resolution stays
    >= 16 samples/period at f0_max (parabolic interpolation keeps the
    sub-sample estimate) and runs the FFTs in f32.
    """
    factor = 1
    if decimate:
        while (
            sample_rate / (factor * 2) >= 16.0 * f0_max
            and hop_size % (factor * 2) == 0
            and len(audio) > 4 * factor
        ):
            factor *= 2
    if factor > 1:
        # polyphase FIR decimation (strided samples of the original grid:
        # the effective rate is exactly sample_rate/factor, no skew term) —
        # the same taps drive the device YIN (features/yin_device.py),
        # keeping host and device YIN numerically identical
        audio = _decimate_fir(audio, factor)
        sample_rate = sample_rate / factor
        hop_size //= factor
    # f32 in fast (decimated) mode; decimate=False keeps the original f64
    # numerics (cmndf is a difference of large cumsums — callers opting out
    # of the fast path get the cancellation-safe dtype back)
    audio = np.asarray(audio, dtype=np.float32 if decimate else np.float64)
    tau_max = int(sample_rate / f0_min) + 1
    tau_min = max(int(sample_rate / f0_max), 2)
    win = tau_max  # integration window
    frame_len = win + tau_max
    n_frames = int(len(audio) // hop_size) + 1

    pad = frame_len
    x = np.pad(audio, (frame_len // 2, pad))
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(frame_len)[None, :]
    frames = x[idx]  # (T, frame_len)

    # difference function d(tau) = sum_{j<win} (x[j] - x[j+tau])^2
    #   = e0 + e_tau - 2 * c(tau),  c(tau) = sum_{j<win} x[j] x[j+tau]
    # computed with one FFT cross-correlation per frame
    n_fft = 1 << int(np.ceil(np.log2(2 * frame_len)))
    head = np.fft.rfft(frames[:, :win], n_fft, axis=1)
    full = np.fft.rfft(frames, n_fft, axis=1)
    corr = np.fft.irfft(np.conj(head) * full, n_fft, axis=1)[:, :tau_max]  # (T, tau)
    csum = np.cumsum(frames**2, axis=1)
    csum = np.pad(csum, ((0, 0), (1, 0)))
    e0 = csum[:, win] - csum[:, 0]  # scalar per frame
    taus = np.arange(tau_max)
    e_tau = csum[:, taus + win] - csum[:, taus]  # (T, tau)
    d = e0[:, None] + e_tau - 2.0 * corr
    d = np.maximum(d, 0.0)

    # cumulative-mean-normalized difference
    dsum = np.cumsum(d[:, 1:], axis=1)
    cmndf = np.ones_like(d)
    cmndf[:, 1:] = d[:, 1:] * np.arange(1, tau_max) / np.maximum(dsum, 1e-12)

    region = cmndf[:, tau_min:tau_max]
    n_tau = region.shape[1]
    t_idx = np.arange(region.shape[0])
    below = region < threshold
    first = np.where(below.any(axis=1), below.argmax(axis=1), region.argmin(axis=1))
    # descend to the first local minimum at/after the crossing point:
    # the first index q >= first where cmndf stops decreasing
    rising = np.concatenate(
        [region[:, 1:] >= region[:, :-1], np.ones((region.shape[0], 1), bool)], axis=1
    )
    eligible = rising & (np.arange(n_tau)[None, :] >= first[:, None])
    cur = eligible.argmax(axis=1)  # first rising point >= first (always exists)
    tau = cur + tau_min

    # parabolic interpolation around tau
    tau_c = np.clip(tau, tau_min + 1, tau_max - 2)
    d0 = cmndf[t_idx, tau_c - 1]
    d1 = cmndf[t_idx, tau_c]
    d2 = cmndf[t_idx, tau_c + 1]
    denom = d0 + d2 - 2.0 * d1
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (d0 - d2) / np.maximum(np.abs(denom), 1e-12) * np.sign(denom), 0.0)
    delta = np.clip(delta, -1.0, 1.0)
    tau_f = tau_c + np.where(tau == tau_c, delta, 0.0)

    f0 = sample_rate / np.maximum(tau_f, 1e-6)
    voiced = (cmndf[t_idx, tau_c] < voicing_threshold) & (f0 >= f0_min) & (f0 <= f0_max)
    # also require actual signal energy
    voiced &= e0 > 1e-8
    return np.where(voiced, f0, 0.0).astype(np.float32)


def _weights_path(kind: str) -> str:
    """Where the JAX package's extractor looks for ``kind``'s converted
    weights: its default path, or the DDSP_SVC_TPU_<KIND>_CKPT override."""
    return os.environ.get(f"DDSP_SVC_TPU_{kind.upper()}_CKPT",
                          _DEFAULT_WEIGHTS[kind])


class F0Extractor:
    """The JAX package's F0 front-end for the 'yin' extractor (the
    reference's F0_Extractor contract)."""

    def __init__(self, f0_extractor: str, sample_rate: int = 44100,
                 hop_size: int = 512, f0_min: float = 65.0,
                 f0_max: float = 800.0, model_params=None):
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.f0_min = f0_min
        self.f0_max = f0_max
        if f0_extractor in _DEFAULT_WEIGHTS:
            path = _weights_path(f0_extractor)
            if model_params is not None or (
                    os.path.exists(path) and path.endswith((".msgpack", ".npz"))):
                raise NotImplementedError(
                    f"f0 extractor {f0_extractor!r} with converted weights "
                    + _NOT_PORTED)
            # pretrained nets are useless at random init: fall back to YIN
            # with the JAX package's warning
            print(f" [!] no converted {f0_extractor} weights at {path!r} — "
                  "falling back to the built-in YIN extractor")
            f0_extractor = "yin"
        if f0_extractor in ("parselmouth", "praat", "dio", "harvest"):
            raise NotImplementedError(f"f0 extractor {f0_extractor!r} " + _NOT_PORTED)
        if f0_extractor != "yin":
            raise ValueError(
                f" [x] Unknown or unavailable f0 extractor: {f0_extractor} "
                "(built-ins: yin, rmvpe, crepe; optional: parselmouth, dio, "
                "harvest, fcpe)")
        self.f0_extractor = f0_extractor

    def extract(self, audio: np.ndarray, uv_interp: bool = False,
                silence_front: float = 0.0) -> np.ndarray:
        """1-D audio -> (len // hop + 1,) f0 in Hz, 0 where unvoiced and in
        the first ``silence_front`` seconds (rounded down to whole frames,
        which YIN skips). ``uv_interp`` fills the zeros by interpolation
        and floors the track at ``f0_min``."""
        n_frames = int(len(audio) // self.hop_size) + 1
        start_frame = int(silence_front * self.sample_rate / self.hop_size)
        real_silence_front = start_frame * self.hop_size / self.sample_rate
        audio = audio[int(np.round(real_silence_front * self.sample_rate)):]
        f0 = yin_f0(audio, self.sample_rate, self.hop_size, self.f0_min,
                    self.f0_max)[: n_frames - start_frame]
        f0 = np.pad(f0, (start_frame, max(0, n_frames - start_frame - len(f0))))
        f0 = np.asarray(f0, dtype=np.float32)
        if uv_interp:
            f0 = _interp_unvoiced(f0)
            f0[f0 < self.f0_min] = self.f0_min
        return f0
