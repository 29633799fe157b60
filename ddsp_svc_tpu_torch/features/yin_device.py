"""YIN on the device: a torch mirror of the host ``yin_f0`` (features/f0.py)
that keeps a request's f0 on the card (the port's counterpart of
ddsp_svc_tpu/features/yin_jax.py: ``interp_unvoiced``, ``make_yin_fn``,
``make_pipeline_f0_fn``).

Everything that shapes the computation (decimation factor, tau range, frame
count, FFT size) is resolved on the host in ``make_yin_fn`` from the audio
length; the returned function runs on whatever device its input lies on:
the shared decimation taps as a strided ``F.conv1d``, one f32 FFT
cross-correlation per frame, and the cumulative-mean-normalised difference
with the host's threshold, descent and parabolic refinement.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .f0 import decimation_filter


def interp_unvoiced(f0: torch.Tensor) -> torch.Tensor:
    """Torch mirror of features/f0.py ``_interp_unvoiced`` (np.interp over
    the voiced frames, clamped at the edges; an all-unvoiced track is
    returned unchanged). (T,) or rows (B, T) in, the same shape out."""
    n = f0.shape[-1]
    voiced = f0 > 0
    idx = torch.arange(n, device=f0.device).expand_as(f0)
    # nearest voiced index at/before i (-1: none), at/after i (n: none)
    prev = torch.cummax(torch.where(voiced, idx, -1), -1).values
    nxt_rev = torch.cummax(torch.where(voiced.flip(-1), idx, -1), -1).values.flip(-1)
    nxt = torch.where(nxt_rev >= 0, (n - 1) - nxt_rev, n)
    fp = torch.gather(f0, -1, prev.clamp(0, n - 1))
    fn = torch.gather(f0, -1, nxt.clamp(0, n - 1))
    have_p, have_n = prev >= 0, nxt <= n - 1
    t = (idx - prev).to(f0.dtype) / (nxt - prev).clamp(min=1).to(f0.dtype)
    interp = torch.where(have_p & have_n, fp + (fn - fp) * t,
                         torch.where(have_p, fp,
                                     torch.where(have_n, fn, torch.zeros_like(f0))))
    return torch.where(voiced, f0, interp)


def make_yin_fn(n_samples: int, sample_rate: int, hop_size: int,
                f0_min: float = 65.0, f0_max: float = 800.0,
                threshold: float = 0.1, voicing_threshold: float = 0.35,
                decimate: bool = True):
    """``fn(audio (n_samples,) or rows (B, n_samples)) -> f0 (n_samples //
    hop_size + 1,) or (B, ...)`` matching ``yin_f0(audio, sample_rate,
    hop_size, ...)`` row by row (0 = unvoiced) on the device of ``audio``,
    in f32 (JAX: the same function vmapped over rows)."""
    factor = 1
    if decimate:
        while (sample_rate / (factor * 2) >= 16.0 * f0_max
               and hop_size % (factor * 2) == 0 and n_samples > 4 * factor):
            factor *= 2
    n_frames_out = n_samples // hop_size + 1
    n_dec = n_samples // factor
    sr_eff = sample_rate / factor
    hop_dec = hop_size // factor
    taps = torch.from_numpy(decimation_filter(factor)) if factor > 1 else None

    tau_max = int(sr_eff / f0_min) + 1
    tau_min = max(int(sr_eff / f0_max), 2)
    win = tau_max
    frame_len = win + tau_max
    n_frames = n_dec // hop_dec + 1
    n_fft = 1 << int(np.ceil(np.log2(2 * frame_len)))

    def rows(audio: torch.Tensor) -> torch.Tensor:  # (B, n) -> (B, T)
        dev = audio.device
        b = audio.shape[0]
        audio = audio.to(torch.float32)
        if factor > 1:
            half = taps.shape[0] // 2
            audio = F.conv1d(audio[:, None], taps.to(dev)[None, None],
                             stride=factor, padding=half)[:, 0, :n_dec]
        x = F.pad(audio, (frame_len // 2, frame_len))
        idx = (torch.arange(n_frames, device=dev)[:, None] * hop_dec
               + torch.arange(frame_len, device=dev)[None, :])
        frames = x[:, idx]  # (B, T, frame_len)

        # d(tau) = e0 + e_tau - 2 c(tau) via one FFT cross-correlation per frame
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
        n_tau = region.shape[-1]
        below = region < threshold
        first = torch.where(below.any(dim=-1), below.to(torch.uint8).argmax(dim=-1),
                            region.argmin(dim=-1))
        rising = torch.cat([region[..., 1:] >= region[..., :-1],
                            torch.ones((b, n_frames, 1), dtype=torch.bool,
                                       device=dev)], dim=-1)
        eligible = rising & (torch.arange(n_tau, device=dev)
                             >= first[..., None])
        tau = eligible.to(torch.uint8).argmax(dim=-1) + tau_min

        tau_c = torch.clamp(tau, tau_min + 1, tau_max - 2)
        d0, d1, d2 = (torch.gather(cmndf, -1, (tau_c + o)[..., None])[..., 0]
                      for o in (-1, 0, 1))
        denom = d0 + d2 - 2.0 * d1
        delta = torch.where(
            denom.abs() > 1e-12,
            0.5 * (d0 - d2) / torch.clamp(denom.abs(), min=1e-12) * torch.sign(denom),
            torch.zeros_like(denom))
        delta = torch.clamp(delta, -1.0, 1.0)
        tau_f = tau_c + torch.where(tau == tau_c, delta, torch.zeros_like(delta))

        # a 0-dim numerator: true division on every device (a Python scalar
        # over a tensor is a reciprocal and a product)
        f0 = (torch.full((), sr_eff, dtype=torch.float32, device=dev)
              / torch.clamp(tau_f, min=1e-6))
        voiced = ((d1 < voicing_threshold) & (f0 >= f0_min) & (f0 <= f0_max)
                  & (e0 > 1e-8))
        f0 = torch.where(voiced, f0, torch.zeros_like(f0))
        return f0[..., :n_frames_out]

    def fn(audio: torch.Tensor) -> torch.Tensor:
        return rows(audio[None])[0] if audio.dim() == 1 else rows(audio)

    return fn


def make_pipeline_f0_fn(n_samples: int, sample_rate: int, hop_size: int,
                        f0_min: float, f0_max: float, start_frame: int = 0):
    """The pipeline's whole f0 front-end on the device: YIN on the suffix
    after ``start_frame`` frames, the front zero pad, the unvoiced
    interpolation and the ``f0_min`` floor -- the host sequence
    ``F0Extractor('yin').extract(audio, uv_interp=True, silence_front=...)``.
    ``fn(audio (n_samples,) or rows (B, n_samples)) -> f0 (n_samples //
    hop_size + 1,) or (B, ...)``, each row on its own."""
    n_frames = n_samples // hop_size + 1
    n_suffix = n_samples - start_frame * hop_size
    yin = make_yin_fn(n_suffix, sample_rate, hop_size, f0_min, f0_max)
    n_keep = n_frames - start_frame

    def fn(audio: torch.Tensor) -> torch.Tensor:
        f0 = yin(audio[..., n_samples - n_suffix:])[..., :n_keep]
        f0 = F.pad(f0, (start_frame, max(0, n_keep - f0.shape[-1])))
        return torch.clamp(interp_unvoiced(f0), min=f0_min)

    return fn
