"""torch.stft / torch.istft-compatible STFT pair (mirrors
ddsp_svc_tpu/ops/spectral.py: ``frame_signal``, ``stft``, ``istft``).

Framing, windowing and the overlap-add are written out as in the JAX
package, so both sides do the same arithmetic in the same order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .window import hann_window


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, 1 + (L - frame_length) // hop, frame_length)."""
    return x.unfold(-1, frame_length, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, n_frames, n) -> (B, (n_frames - 1) * hop + n); hop divides n."""
    b, t, n = frames.shape
    if n % hop:
        raise ValueError(f"hop {hop} must divide the frame length {n}")
    r = n // hop
    chunks = frames.reshape(b, t, r, hop)
    slots = frames.new_zeros(b, t + r - 1, hop)
    for k in range(r):
        slots[:, k:k + t] += chunks[:, :, k]
    return slots.reshape(b, (t + r - 1) * hop)


def _hann(n_fft: int, like: torch.Tensor, window=None) -> torch.Tensor:
    if window is None:
        window = torch.from_numpy(hann_window(n_fft)).to(like.device)
    return window


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         window: torch.Tensor | None = None, pad_mode: str = "reflect"
         ) -> torch.Tensor:
    """Centred STFT (window = n_fft, periodic Hann by default):
    (B, L) -> complex (B, n_fft // 2 + 1, n_frames), freq-major as torch."""
    window = _hann(n_fft, x, window)
    p = n_fft // 2
    x = F.pad(x[:, None, :], (p, p), mode=pad_mode)[:, 0, :]
    frames = frame_signal(x, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n_fft, dim=-1).transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          window: torch.Tensor | None = None, length: int | None = None
          ) -> torch.Tensor:
    """Inverse of the centred ``stft``: complex (B, n_fft // 2 + 1,
    n_frames) -> (B, L) with squared-window overlap-add normalisation."""
    window = _hann(n_fft, spec, window)
    frames = torch.fft.irfft(spec.transpose(1, 2), n_fft, dim=-1)
    n_frames = frames.shape[1]
    y = overlap_add(frames * window, hop_length)
    wsq = (window * window).expand(1, n_frames, n_fft).to(frames.dtype)
    norm = overlap_add(wsq, hop_length)[0]
    y = y / torch.clamp(norm, min=1e-11)
    y = y[:, n_fft // 2: y.shape[1] - n_fft // 2]
    return y if length is None else y[:, :length]


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Magnitude spectrogram with torchaudio's Spectrogram(power=1,
    normalized=True, center=False) semantics, as the SSS loss takes it:
    (B, L) -> (B, n_fft // 2 + 1, n_frames)."""
    window = _hann(n_fft, x)
    frames = frame_signal(x, n_fft, hop_length) * window
    mag = torch.abs(torch.fft.rfft(frames, n_fft, dim=-1))
    return (mag / torch.sqrt(torch.sum(window * window))).transpose(1, 2)
