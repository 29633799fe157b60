"""Linear time-varying FIR filtering in the frequency domain (mirrors
ddsp_svc_tpu/ops/fir.py: ``fft_convolve``, ``apply_window_to_impulse_response``,
``apply_dynamic_window_to_impulse_response``, ``frequency_impulse_response``,
``frequency_filter``).

The FFT size is rounded up to a power of two, as in JAX: it only has to
reach frame + ir - 1 for a linear convolution, so the overlap-add output is
the same sample for sample after the group-delay crop.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .spectral import frame_signal, overlap_add
from .window import bartlett_window, hann_window


def get_fft_size(frame_size: int, ir_size: int) -> int:
    """Next power of two >= frame_size + ir_size - 1."""
    return int(2 ** np.ceil(np.log2(frame_size + ir_size - 1)))


def _window(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(w).to(device=like.device, dtype=like.dtype)


def fft_convolve(audio: torch.Tensor, impulse_response: torch.Tensor
                 ) -> torch.Tensor:
    """audio (B, L) filtered by impulse responses (B, ir) (time-invariant)
    or (B, n_frames, ir) with n_frames dividing L: 50 %-overlap Bartlett
    frames, rFFT, multiply, irFFT, overlap-add, group-delay crop -> (B, L)."""
    if impulse_response.dim() == 2:
        impulse_response = impulse_response[:, None, :]
    b_ir, n_ir_frames, ir_size = impulse_response.shape
    b, audio_size = audio.shape
    if b != b_ir:
        raise ValueError(f"batch {b} of the audio != batch {b_ir} of the IR")
    hop = audio_size // n_ir_frames
    frame_size = 2 * hop
    frames = frame_signal(F.pad(audio, (hop, hop)), frame_size, hop)
    frames = frames * _window(bartlett_window(frame_size), frames)
    fft_size = get_fft_size(frame_size, ir_size)
    audio_fft = torch.fft.rfft(frames, fft_size, dim=-1)
    ir = torch.cat([impulse_response, impulse_response[:, -1:, :]], dim=1)
    ir_fft = torch.fft.rfft(ir, fft_size, dim=-1)
    out_frames = torch.fft.irfft(audio_fft * ir_fft, fft_size, dim=-1)
    signal = overlap_add(out_frames, hop)
    start = hop + ir_size // 2
    return signal[:, start:start + audio_size]


def apply_window_to_impulse_response(impulse_response: torch.Tensor,
                                     window_size: int = 0,
                                     causal: bool = False) -> torch.Tensor:
    """Hann-window an impulse response and put it in causal form."""
    if causal:
        impulse_response = torch.fft.fftshift(impulse_response, dim=-1)
    ir_size = impulse_response.shape[-1]
    if window_size <= 0 or window_size > ir_size:
        window_size = ir_size
    window = _window(hann_window(window_size), impulse_response)
    padding = ir_size - window_size
    if padding > 0:
        half_idx = (window_size + 1) // 2
        window = torch.cat([window[half_idx:], window.new_zeros(padding),
                            window[:half_idx]])
    else:
        window = torch.roll(window, window.shape[-1] // 2)
    impulse_response = impulse_response * window
    if padding > 0:
        first_half_start = (ir_size - (half_idx - 1)) + 1
        second_half_end = half_idx + 1
        return torch.cat([impulse_response[..., first_half_start:],
                          impulse_response[..., :second_half_end]], dim=-1)
    return torch.roll(impulse_response, ir_size // 2, dims=-1)


def apply_dynamic_window_to_impulse_response(
        impulse_response: torch.Tensor, half_width_frames: torch.Tensor
) -> torch.Tensor:
    """Per-frame raised-cosine window of half width ``half_width_frames``
    (B, n_frames, 1) on impulse responses (B, n_frames, ir)."""
    ir_size = impulse_response.shape[-1]
    pos = torch.arange(-(ir_size // 2), (ir_size + 1) // 2,
                       dtype=impulse_response.dtype,
                       device=impulse_response.device)
    w = pos / half_width_frames
    w = torch.where(w > 1.0, torch.zeros_like(w), w)
    window = (1.0 + torch.cos(math.pi * w)) / 2.0
    return torch.roll(impulse_response, ir_size // 2, dims=-1) * window


def frequency_impulse_response(magnitudes: torch.Tensor,
                               hann_window_flag: bool = True,
                               half_width_frames: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Complex frequency response (B, T, n) -> windowed impulse response
    (B, T, 2 (n - 1))."""
    impulse_response = torch.fft.irfft(magnitudes, dim=-1)
    if not hann_window_flag:
        return torch.roll(impulse_response, impulse_response.shape[-1] // 2,
                          dims=-1)
    if half_width_frames is None:
        return apply_window_to_impulse_response(impulse_response)
    return apply_dynamic_window_to_impulse_response(impulse_response,
                                                    half_width_frames)


def frequency_filter(audio: torch.Tensor, magnitudes: torch.Tensor,
                     hann_window_flag: bool = True,
                     half_width_frames: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """LTV filtering of audio (B, L) by a frame-wise complex frequency
    response (B, T, n)."""
    return fft_convolve(audio, frequency_impulse_response(
        magnitudes, hann_window_flag, half_width_frames))
