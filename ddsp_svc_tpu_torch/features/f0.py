"""The f0 front end (mirrors ddsp_svc_tpu/features/f0.py:
``decimation_filter``, ``_decimate_fir``, ``_interp_unvoiced``,
``_regrid_10ms``, ``yin_f0`` and the ``F0Extractor`` dispatch).

  - 'yin': the built-in vectorised YIN (de Cheveigne & Kawahara 2002) on
    the synth hop grid, host numpy.
  - 'rmvpe', 'crepe', 'fcpe': the f0 nets (features/rmvpe.py, crepe.py,
    fcpe.py) on the extractor's device, the CUDA card unless told, with
    converted weights in the JAX package's format; without them the
    extractor warns and falls back to YIN, as the JAX package does. 'fcpe'
    takes the torchfcpe wheel instead when it is installed and no weights
    are given.
  - 'praat', 'parselmouth', 'dio', 'harvest': the host numpy trackers
    (features/praat.py, dio.py, harvest.py), or the parselmouth / pyworld
    wheels where installed ('parselmouth', 'dio', 'harvest'), tried in the
    JAX package's order.

All paths share the framing contract: n_frames = len // hop + 1,
``silence_front`` frame skipping, optional unvoiced interpolation and the
``f0_min`` floor.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io.jax_params import f0_net_state_dict, load_params
from ..ops.interp import masked_avg_pool_1d, median_pool_1d
from ..utils.device import resolve_device

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


def _regrid_10ms(f0: np.ndarray, uv: np.ndarray, hop_size: int,
                 sample_rate: int, n_out: int) -> np.ndarray:
    """A 10 ms-grid f0 track -> the synth hop grid (unvoiced frames
    interpolated first, then zeroed where the regridded voicing is under
    one half)."""
    f0 = _interp_unvoiced(f0)
    origin_time = 0.01 * np.arange(len(f0))
    target_time = hop_size / sample_rate * np.arange(n_out)
    out = np.interp(target_time, origin_time, f0)
    uv_t = np.interp(target_time, origin_time, uv.astype(float)) > 0.5
    out[uv_t] = 0
    return out


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
    """The reference's F0_Extractor contract, as the JAX package's.

    ``model_params``: an f0 net's converted flax variables (read from the
    default weights file when not given); ``use_viterbi``: RMVPE decodes
    around the Viterbi-smoothed path; ``device``: where the nets run (None:
    the CUDA card; the host trackers stay on the host)."""

    def __init__(self, f0_extractor: str, sample_rate: int = 44100,
                 hop_size: int = 512, f0_min: float = 65.0,
                 f0_max: float = 800.0, model_params=None,
                 use_viterbi: bool = False,
                 device: str | torch.device | None = None):
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.f0_min = f0_min
        self.f0_max = f0_max
        self.use_viterbi = use_viterbi
        self._device = device
        self._fcpe_wheel = False
        if f0_extractor == "fcpe" and model_params is None:
            try:  # the torchfcpe wheel, when installed
                import torchfcpe  # noqa: F401
            except ImportError:
                pass
            else:
                self._fcpe_wheel = True
        if f0_extractor in _DEFAULT_WEIGHTS and not self._fcpe_wheel \
                and model_params is None:
            # a net at random init extracts no pitch: read the converted
            # weights, else fall back to YIN with the JAX package's warning
            path = _weights_path(f0_extractor)
            model_params = load_params(path)
            if model_params is None:
                print(f" [!] no converted {f0_extractor} weights at {path!r} — "
                      "falling back to the built-in YIN extractor")
                f0_extractor = "yin"
        if f0_extractor not in _KINDS:
            raise ValueError(
                f" [x] Unknown or unavailable f0 extractor: {f0_extractor} "
                "(built-ins: yin, rmvpe, crepe; optional: parselmouth, dio, "
                "harvest, fcpe)")
        self.f0_extractor = f0_extractor
        self.net = None
        if f0_extractor in _DEFAULT_WEIGHTS and model_params is not None:
            device = resolve_device(device)  # no card: raise before mapping
            self.net = _NETS[f0_extractor](
                f0_net_state_dict(f0_extractor, model_params), device=device)

    def _pyworld_f0(self, pw, audio, kind, n_frames, start_frame):
        """The pyworld wheel's dio + stonemask or harvest."""
        frame_period = 1000 * self.hop_size / self.sample_rate
        if kind == "dio":
            _f0, t = pw.dio(audio.astype("double"), self.sample_rate,
                            f0_floor=self.f0_min, f0_ceil=self.f0_max,
                            channels_in_octave=2, frame_period=frame_period)
            f0 = pw.stonemask(audio.astype("double"), _f0, t, self.sample_rate)
        else:
            f0, _ = pw.harvest(audio.astype("double"), self.sample_rate,
                               f0_floor=self.f0_min, f0_ceil=self.f0_max,
                               frame_period=frame_period)
        return np.pad(f0.astype("float"),
                      (start_frame, n_frames - len(f0) - start_frame))

    def _host_tracker(self, fn, audio, n_frames, start_frame):
        f0 = fn(audio, self.sample_rate, self.hop_size, self.f0_min,
                self.f0_max)[: n_frames - start_frame]
        return np.pad(f0, (start_frame, n_frames - start_frame - len(f0)))

    def _parselmouth_f0(self, parselmouth, audio, n_frames, start_frame):
        """The parselmouth wheel's ``to_pitch_ac``."""
        l_pad = int(np.ceil(1.5 / self.f0_min * self.sample_rate))
        r_pad = (self.hop_size * ((len(audio) - 1) // self.hop_size + 1)
                 - len(audio) + l_pad + 1)
        s = parselmouth.Sound(np.pad(audio, (l_pad, r_pad)),
                              self.sample_rate).to_pitch_ac(
            time_step=self.hop_size / self.sample_rate, voicing_threshold=0.6,
            pitch_floor=self.f0_min, pitch_ceiling=self.f0_max)
        assert np.abs(s.t1 - 1.5 / self.f0_min) < 0.001
        f0 = np.pad(s.selected_array["frequency"], (start_frame, 0))
        if len(f0) < n_frames:
            f0 = np.pad(f0, (0, n_frames - len(f0)))
        return f0[:n_frames]

    def _fcpe_wheel_f0(self, audio):
        """The torchfcpe wheel's bundled model, local-argmax decoded."""
        from torchfcpe import spawn_bundled_infer_model

        device = str(resolve_device(self._device))
        fcpe = spawn_bundled_infer_model(device=device)
        return fcpe(torch.from_numpy(audio).unsqueeze(0).to(device),
                    sr=self.sample_rate, decoder_mode="local_argmax",
                    threshold=0.006).squeeze().cpu().numpy()

    def extract(self, audio: np.ndarray, uv_interp: bool = False,
                silence_front: float = 0.0) -> np.ndarray:
        """1-D audio -> (len // hop + 1,) f0 in Hz, 0 where unvoiced and in
        the first ``silence_front`` seconds (rounded down to whole frames,
        which the trackers skip). ``uv_interp`` fills the zeros by
        interpolation and floors the track at ``f0_min``."""
        n_frames = int(len(audio) // self.hop_size) + 1
        start_frame = int(silence_front * self.sample_rate / self.hop_size)
        real_silence_front = start_frame * self.hop_size / self.sample_rate
        audio = audio[int(np.round(real_silence_front * self.sample_rate)):]
        n_out = n_frames - start_frame

        kind = self.f0_extractor
        if kind == "yin":
            f0 = self._host_tracker(yin_f0, audio, n_frames, start_frame)
        elif kind == "crepe":
            f0_5ms, pd = self.net.infer_from_audio(
                audio, self.sample_rate, fmin=self.f0_min, fmax=self.f0_max)
            # median-pooled periodicity thresholded at 0.05, then the
            # masked average of the voiced frames, on the 5 ms grid
            pd = median_pool_1d(torch.from_numpy(pd)[None], 4)[0].numpy()
            f0_5ms = np.where(pd < 0.05, np.nan, f0_5ms).astype(np.float32)
            f0_s = masked_avg_pool_1d(torch.from_numpy(f0_5ms)[None], 4)[0].numpy()
            idx = np.minimum(np.round(
                np.arange(n_out) * self.hop_size / self.sample_rate / 0.005
            ).astype(int), len(f0_s) - 1)
            f0 = np.pad(np.nan_to_num(f0_s[idx]), (start_frame, 0))
        elif kind in ("rmvpe", "fcpe"):
            if kind == "rmvpe":
                f0_10ms = self.net.infer_from_audio(
                    audio, self.sample_rate, thred=0.03,
                    use_viterbi=self.use_viterbi)
            elif self.net is not None:
                f0_10ms = self.net.infer_from_audio(audio, self.sample_rate,
                                                    threshold=0.006)
            else:
                f0_10ms = self._fcpe_wheel_f0(audio)
            f0 = _regrid_10ms(f0_10ms, f0_10ms == 0, self.hop_size,
                              self.sample_rate, n_out)
            f0 = np.pad(f0, (start_frame, 0))
        elif kind in ("parselmouth", "praat"):
            try:
                if kind == "praat":
                    raise ImportError  # the host tracker, asked for by name
                import parselmouth
            except ImportError:
                from .praat import praat_ac_f0

                f0 = self._host_tracker(praat_ac_f0, audio, n_frames, start_frame)
            else:
                f0 = self._parselmouth_f0(parselmouth, audio, n_frames,
                                          start_frame)
        else:  # dio, harvest
            try:
                import pyworld as pw
            except ImportError:
                if kind == "dio":
                    from .dio import dio_stonemask_f0 as native_f0
                else:
                    from .harvest import harvest_stonemask_f0 as native_f0
                f0 = self._host_tracker(native_f0, audio, n_frames, start_frame)
            else:
                f0 = self._pyworld_f0(pw, audio, kind, n_frames, start_frame)

        f0 = np.asarray(f0, dtype=np.float32)
        if uv_interp:
            f0 = _interp_unvoiced(f0)
            f0[f0 < self.f0_min] = self.f0_min
        return f0


def _rmvpe(state, device):
    from .rmvpe import RMVPE

    return RMVPE(state, device=device)


def _crepe(state, device):
    from .crepe import CrepeInfer

    return CrepeInfer(state, device=device)


def _fcpe(state, device):
    from .fcpe import FCPEInfer

    return FCPEInfer(state, device=device)


_NETS = {"rmvpe": _rmvpe, "crepe": _crepe, "fcpe": _fcpe}
_KINDS = ("yin", "rmvpe", "crepe", "fcpe", "parselmouth", "praat", "dio",
          "harvest")
