"""YIN f0 in float32: polyphase decimation, one FFT cross-correlation per
frame, the cumulative-mean-normalised difference, the first dip under the
threshold (else the minimum) descended to its local minimum, parabolic
refinement, the voicing test; then unvoiced frames interpolated between
voiced ones (held at the edges) and floored at ``f0_min``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def decimation_taps(factor: int) -> np.ndarray:
    """Kaiser (beta 9) windowed-sinc low-pass, cutoff 0.92 of the decimated
    Nyquist, 32 factor + 1 taps, unit DC gain, designed in float64."""
    taps = 32 * factor + 1
    cutoff = 0.92 * 0.5 / factor
    t = np.arange(taps, dtype=np.float64) - (taps - 1) / 2
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * t) * np.kaiser(taps, 9.0)
    return (h / h.sum()).astype(np.float32)


def interp_unvoiced(f0: torch.Tensor) -> torch.Tensor:
    """Rows (B, T): each unvoiced (0) frame linearly interpolated between
    the nearest voiced frames, held at the edges; all-unvoiced rows stay."""
    n = f0.shape[-1]
    voiced = f0 > 0
    idx = torch.arange(n, device=f0.device).expand_as(f0)
    prev = torch.cummax(torch.where(voiced, idx, -1), -1).values
    nxt_rev = torch.cummax(torch.where(voiced.flip(-1), idx, -1), -1).values.flip(-1)
    nxt = torch.where(nxt_rev >= 0, (n - 1) - nxt_rev, n)
    fp = torch.gather(f0, -1, prev.clamp(0, n - 1))
    fn = torch.gather(f0, -1, nxt.clamp(0, n - 1))
    have_p, have_n = prev >= 0, nxt <= n - 1
    t = (idx - prev).to(f0.dtype) / (nxt - prev).clamp(min=1).to(f0.dtype)
    filled = torch.where(have_p & have_n, fp + (fn - fp) * t,
                         torch.where(have_p, fp, torch.where(have_n, fn,
                                                             torch.zeros_like(f0))))
    return torch.where(voiced, f0, filled)


def yin(audio: torch.Tensor, sample_rate: int, hop_size: int, f0_min: float,
        f0_max: float, threshold: float = 0.1,
        voicing_threshold: float = 0.35) -> torch.Tensor:
    """audio rows (B, n) -> f0 (B, n // hop + 1) in Hz, 0 = unvoiced."""
    n_samples = audio.shape[-1]
    dev = audio.device
    factor = 1
    while (sample_rate / (factor * 2) >= 16.0 * f0_max
           and hop_size % (factor * 2) == 0 and n_samples > 4 * factor):
        factor *= 2
    n_out = n_samples // hop_size + 1
    n_dec = n_samples // factor
    sr_eff, hop = sample_rate / factor, hop_size // factor
    tau_max = int(sr_eff / f0_min) + 1
    tau_min = max(int(sr_eff / f0_max), 2)
    win = tau_max
    frame_len = win + tau_max
    n_frames = n_dec // hop + 1
    n_fft = 1 << int(np.ceil(np.log2(2 * frame_len)))
    b = audio.shape[0]
    if factor > 1:
        taps = torch.from_numpy(decimation_taps(factor)).to(dev)
        audio = F.conv1d(audio[:, None], taps[None, None], stride=factor,
                         padding=taps.shape[0] // 2)[:, 0, :n_dec]
    x = F.pad(audio, (frame_len // 2, frame_len))
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(frame_len, device=dev)[None, :])
    frames = x[:, idx]
    head = torch.fft.rfft(frames[..., :win], n_fft, dim=-1)
    full = torch.fft.rfft(frames, n_fft, dim=-1)
    corr = torch.fft.irfft(torch.conj(head) * full, n_fft, dim=-1)[..., :tau_max]
    csum = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    taus = torch.arange(tau_max, device=dev)
    e0 = csum[..., win] - csum[..., 0]
    e_tau = csum[..., taus + win] - csum[..., taus]
    d = torch.clamp(e0[..., None] + e_tau - 2.0 * corr, min=0.0)
    dsum = torch.cumsum(d[..., 1:], dim=-1)
    lags = torch.arange(1, tau_max, device=dev, dtype=torch.float32)
    cmndf = torch.cat([torch.ones((b, n_frames, 1), device=dev),
                       d[..., 1:] * lags / torch.clamp(dsum, min=1e-12)], dim=-1)
    region = cmndf[..., tau_min:tau_max]
    below = region < threshold
    first = torch.where(below.any(dim=-1), below.to(torch.uint8).argmax(dim=-1),
                        region.argmin(dim=-1))
    rising = torch.cat([region[..., 1:] >= region[..., :-1],
                        torch.ones((b, n_frames, 1), dtype=torch.bool, device=dev)],
                       dim=-1)
    eligible = rising & (torch.arange(region.shape[-1], device=dev) >= first[..., None])
    tau = eligible.to(torch.uint8).argmax(dim=-1) + tau_min
    tau_c = torch.clamp(tau, tau_min + 1, tau_max - 2)
    d0, d1, d2 = (torch.gather(cmndf, -1, (tau_c + o)[..., None])[..., 0]
                  for o in (-1, 0, 1))
    denom = d0 + d2 - 2.0 * d1
    delta = torch.where(denom.abs() > 1e-12,
                        0.5 * (d0 - d2) / torch.clamp(denom.abs(), min=1e-12)
                        * torch.sign(denom), torch.zeros_like(denom))
    tau_f = tau_c + torch.where(tau == tau_c, torch.clamp(delta, -1.0, 1.0),
                                torch.zeros_like(delta))
    f0 = (torch.full((), sr_eff, dtype=torch.float32, device=dev)
          / torch.clamp(tau_f, min=1e-6))
    voiced = (d1 < voicing_threshold) & (f0 >= f0_min) & (f0 <= f0_max) & (e0 > 1e-8)
    return torch.where(voiced, f0, torch.zeros_like(f0))[..., :n_out]


def track(audio: torch.Tensor, sample_rate: int, hop_size: int, f0_min: float,
          f0_max: float) -> torch.Tensor:
    """The served f0 front end: YIN, unvoiced frames filled, the floor."""
    return torch.clamp(interp_unvoiced(yin(audio, sample_rate, hop_size, f0_min,
                                           f0_max)), min=f0_min)
