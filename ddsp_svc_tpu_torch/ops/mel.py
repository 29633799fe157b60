"""Log-mel front-end of the NSF-HiFiGAN vocoder (mirrors
ddsp_svc_tpu/ops/mel.py: ``mel_filterbank`` on the Slaney or the HTK scale,
``LogMelSpectrogram`` with its keyshift and speed)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .spectral import frame_signal
from .window import hann_window


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # f = 0 takes the linear branch
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(f / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False, dtype=np.float32) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank (librosa norm='slaney')
    on the Slaney mel scale, or with ``htk`` on the HTK scale (librosa
    htk=True, RMVPE's front end): (n_mels, n_fft // 2 + 1)."""
    to_mel = _hz_to_mel_htk if htk else _hz_to_mel_slaney
    to_hz = _mel_to_hz_htk if htk else _mel_to_hz_slaney
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(dtype)


class LogMelSpectrogram(nn.Module):
    """nvSTFT.get_mel-compatible log-mel: manual reflect/constant padding,
    center=False framing, magnitude with a 1e-9 floor, slaney mel
    projection, log with a ``clip_val`` floor."""

    def __init__(self, sr: int = 44100, n_mels: int = 128, n_fft: int = 2048,
                 win_size: int = 2048, hop_length: int = 512,
                 fmin: float = 40.0, fmax: float = 16000.0,
                 clip_val: float = 1e-5):
        super().__init__()
        self.sr, self.n_mels, self.n_fft = sr, n_mels, n_fft
        self.win_size, self.hop_length = win_size, hop_length
        self.clip_val = clip_val
        self.register_buffer("mel_basis", torch.from_numpy(
            mel_filterbank(sr, n_fft, n_mels, fmin, fmax)), persistent=False)
        window = torch.from_numpy(hann_window(win_size))
        if win_size < n_fft:
            lpad = (n_fft - win_size) // 2
            window = F.pad(window, (lpad, n_fft - win_size - lpad))
        self.register_buffer("window", window, persistent=False)

    def _window(self, n_fft: int, win_size: int, device) -> torch.Tensor:
        if (n_fft, win_size) == (self.n_fft, self.win_size):
            return self.window
        window = torch.from_numpy(hann_window(win_size)).to(device)
        if win_size < n_fft:
            lpad = (n_fft - win_size) // 2
            window = F.pad(window, (lpad, n_fft - win_size - lpad))
        return window

    def forward(self, y: torch.Tensor, keyshift: float = 0.0,
                speed: float = 1.0) -> torch.Tensor:
        """audio (B, L) -> log-mel (B, n_mels, n_frames). ``keyshift``
        semitones scale n_fft and the window by 2^(keyshift / 12) (the
        magnitudes are cut or zero-padded back to n_fft // 2 + 1 bins and
        rescaled by win_size / the new window); ``speed`` scales the hop."""
        factor = 2.0 ** (keyshift / 12.0)
        n_fft = int(np.round(self.n_fft * factor))
        win = int(np.round(self.win_size * factor))
        hop = int(np.round(self.hop_length * speed))
        pad_left = (win - hop) // 2
        pad_right = max((win - hop + 1) // 2, win - y.shape[-1] - pad_left)
        mode = "reflect" if pad_right < y.shape[-1] else "constant"
        y = F.pad(y[:, None, :], (pad_left, pad_right), mode=mode)[:, 0, :]
        frames = frame_signal(y, n_fft, hop) * self._window(n_fft, win, y.device)
        spec = torch.fft.rfft(frames, n_fft, dim=-1)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9).transpose(1, 2)
        if keyshift != 0.0:
            size = self.n_fft // 2 + 1
            if mag.shape[1] < size:
                mag = F.pad(mag, (0, 0, 0, size - mag.shape[1]))
            mag = mag[:, :size, :] * (self.win_size / win)
        mel = torch.matmul(self.mel_basis, mag)
        return torch.log(torch.clamp(mel, min=self.clip_val))

    def extract(self, audio: torch.Tensor, keyshift: float = 0.0) -> torch.Tensor:
        """Vocoder.extract layout: audio (B, L) -> mel (B, n_frames, n_mels)."""
        return self(audio, keyshift=keyshift).transpose(1, 2)
