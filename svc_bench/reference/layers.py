"""Plain building blocks on (B, T, C) tensors and the signal helpers the
reference shares: convolutions from a weight dict, norms, activations,
framing, the STFT pair, the mel filterbank, the sinc resampler and the
quantised phase carry."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

PHASE_Q_BITS = 22  # phase carries quantised to 2^-22 cycles


def conv(w: dict, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
         dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Conv1d ``name`` (weight (out, in / groups, k), optional bias) on x
    (B, T, C_in) -> (B, T', C_out)."""
    y = F.conv1d(x.transpose(1, 2), w[name + ".weight"], w.get(name + ".bias"),
                 stride, padding, dilation, groups)
    return y.transpose(1, 2)


def linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def layer_norm(w: dict, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"], w[name + ".bias"], eps)


def group_norm(w: dict, name: str, x: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over time and each group's channels of (B, T, C)."""
    y = F.group_norm(x.transpose(1, 2), groups, w[name + ".weight"],
                     w[name + ".bias"], eps)
    return y.transpose(1, 2)


def wn_linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """A weight-normed linear layer: v g / (||v|| + 1e-12) per output row."""
    v, g = w[name + ".weight_v"], w[name + ".weight_g"]
    weight = v * (g / (torch.sqrt(torch.sum(v * v, dim=1)) + 1e-12))[:, None]
    return F.linear(x, weight, w[name + ".bias"])


def gelu(x):
    return F.gelu(x)  # the exact (erf) form


def exact_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor correctly rounded (a 0-dim tensor divisor)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def wrap_half(x: torch.Tensor) -> torch.Tensor:
    return torch.fmod(x + 0.5, 1.0) - 0.5


def carry_cycles(q: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of per-frame increments quantised to 2^-22 cycles
    (B, T, 1) int -> the carry in cycles, mod 1."""
    acc = torch.cumsum(q, dim=1)
    carry = F.pad(acc[:, :-1, :], (0, 0, 1, 0))
    frac = torch.bitwise_and(carry, (1 << PHASE_Q_BITS) - 1)
    return frac.to(torch.float32) / (1 << PHASE_Q_BITS)


def quantise(x: torch.Tensor) -> torch.Tensor:
    return torch.round(wrap_half(x) * (1 << PHASE_Q_BITS)).to(torch.int32)


def upsample(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, C) -> (B, T * factor, C), each frame lerped towards the next
    (the last held)."""
    b, t, c = signal.shape
    nxt = torch.cat([signal[:, 1:], signal[:, -1:]], dim=1)
    wgt = (torch.arange(factor, dtype=signal.dtype, device=signal.device)
           / factor).reshape(1, 1, factor, 1)
    out = signal[:, :, None, :] * (1.0 - wgt) + nxt[:, :, None, :] * wgt
    return out.reshape(b, t * factor, c)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device) * -scale)
    emb = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def hann(n: int, device) -> torch.Tensor:
    k = np.arange(n)
    return torch.from_numpy((0.5 * (1.0 - np.cos(2.0 * np.pi * k / n)))
                            .astype(np.float32)).to(device)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, n_frames, n) -> (B, (n_frames - 1) * hop + n)."""
    b, t, n = frames.shape
    r = n // hop
    chunks = frames.reshape(b, t, r, hop)
    slots = frames.new_zeros(b, t + r - 1, hop)
    for k in range(r):
        slots[:, k:k + t] += chunks[:, :, k]
    return slots.reshape(b, (t + r - 1) * hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, pad_mode: str) -> torch.Tensor:
    """Centred STFT, periodic Hann: (B, L) -> complex (B, frames, bins)."""
    p = n_fft // 2
    x = F.pad(x[:, None, :], (p, p), mode=pad_mode)[:, 0, :]
    frames = x.unfold(-1, n_fft, hop) * hann(n_fft, x.device)
    return torch.fft.rfft(frames, n_fft, dim=-1)


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse of ``stft``: complex (B, frames, bins) -> (B, L), the
    overlap-add normalised by the summed squared window."""
    window = hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n_fft, dim=-1)
    y = overlap_add(frames * window, hop)
    norm = overlap_add((window * window).expand(1, frames.shape[1], n_fft), hop)[0]
    y = y / torch.clamp(norm, min=1e-11)
    return y[:, n_fft // 2: y.shape[1] - n_fft // 2]


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        return np.where(f >= min_log_hz,
                        min_log_hz / f_sp + np.log(f / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """librosa's Slaney-normalised mel filterbank (n_mels, n_fft // 2 + 1)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(audio: torch.Tensor, voc: dict) -> torch.Tensor:
    """NSF-HiFiGAN's log-mel of audio (B, L) -> (B, frames, n_mels): the
    window centred by manual padding, magnitude with a 1e-9 floor, the
    Slaney mel and a log floored at 1e-5."""
    n_fft, win, hop = voc["n_fft"], voc["win_size"], voc["hop_size"]
    pad_left = (win - hop) // 2
    pad_right = max((win - hop + 1) // 2, win - audio.shape[-1] - pad_left)
    mode = "reflect" if pad_right < audio.shape[-1] else "constant"
    y = F.pad(audio[:, None, :], (pad_left, pad_right), mode=mode)[:, 0, :]
    frames = y.unfold(-1, n_fft, hop) * hann(win, y.device)
    spec = torch.fft.rfft(frames, n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.from_numpy(mel_filterbank(voc["sampling_rate"], n_fft,
                                            voc["num_mels"], voc["fmin"],
                                            voc["fmax"])).to(audio.device)
    mel = torch.matmul(mag, basis.t())
    return torch.log(torch.clamp(mel, min=1e-5))


@functools.lru_cache(maxsize=4)
def sinc_kernel(orig_freq: int, new_freq: int, width_zeros: int = 128,
                rolloff: float = 0.99):
    """torchaudio's ``sinc_interp_hann`` polyphase kernel, built in float64:
    (kernels (new, 1, 2 width + orig), width, orig, new)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base = min(orig, new) * rolloff
    width = math.ceil(width_zeros * orig / base)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -width_zeros, width_zeros)
    window = np.cos(t * np.pi / width_zeros / 2) ** 2
    t = t * np.pi
    kern = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kern *= window * base / orig
    return kern.astype(np.float32)[:, None, :], width, orig, new


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """(B, L) -> (B, ceil(new L / orig))."""
    if orig_freq == new_freq:
        return x
    kern, width, orig, new = sinc_kernel(orig_freq, new_freq)
    b, n = x.shape
    y = F.conv1d(F.pad(x[:, None, :], (width, width + orig)),
                 torch.from_numpy(kern).to(x.device), stride=orig)
    return y.transpose(1, 2).reshape(b, -1)[:, :math.ceil(new * n / orig)]
