"""Spectral training losses and mel quality metrics (mirrors
ddsp_svc_tpu/ops/losses.py: ``sss_loss``, ``RSSLoss`` over the same
log-spaced lattice of FFT sizes, ``rss_loss``, ``mel_snr``,
``mel_si_snr``, ``mel_psnr``).

RSS draws ``n_scale`` sizes from a fixed lattice of 16 log-spaced sizes in
[fft_min, fft_max), as the JAX package does (a static set of shapes); the
draw (the lattice indices) can be injected.
"""
from __future__ import annotations

import numpy as np
import torch

from .spectral import spectrogram


def sss_loss(x_true: torch.Tensor, x_pred: torch.Tensor, n_fft: int,
             alpha: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    """Single-scale spectral loss (hop = n_fft, normalised magnitudes):
    spectral convergence + alpha x log-L1."""
    s_true = spectrogram(x_true, n_fft, n_fft) + eps
    s_pred = spectrogram(x_pred, n_fft, n_fft) + eps
    converge = torch.mean(torch.linalg.norm(s_true - s_pred, dim=(1, 2))
                          / torch.linalg.norm(s_true + s_pred, dim=(1, 2)))
    log_term = torch.mean(torch.abs(torch.log(s_true) - torch.log(s_pred)))
    return converge + alpha * log_term


def default_lattice(fft_min: int, fft_max: int, n_sizes: int = 16) -> tuple:
    sizes = np.unique(np.round(np.exp(np.linspace(
        np.log(fft_min), np.log(fft_max - 1), n_sizes))).astype(int))
    return tuple(int(s) for s in sizes)


class RSSLoss:
    """Random-scale spectral loss: the mean SSS loss at ``n_scale`` sizes
    drawn uniformly, with replacement, from the lattice."""

    def __init__(self, fft_min: int, fft_max: int, n_scale: int = 4,
                 alpha: float = 1.0, eps: float = 1e-7,
                 lattice: tuple | None = None):
        self.n_scale, self.alpha, self.eps = n_scale, alpha, eps
        self.sizes = lattice if lattice is not None else default_lattice(
            fft_min, fft_max)

    def __call__(self, x_pred: torch.Tensor, x_true: torch.Tensor,
                 idx=None, generator: torch.Generator | None = None
                 ) -> torch.Tensor:
        """``idx``: the ``n_scale`` lattice indices, drawn from
        ``generator`` when not given."""
        if idx is None:
            idx = torch.randint(0, len(self.sizes), (self.n_scale,),
                                generator=generator,
                                device=generator.device if generator else "cpu")
        idx = [int(i) for i in idx]
        total = 0.0
        for i in idx:
            total = total + sss_loss(x_true, x_pred, self.sizes[i], self.alpha,
                                     self.eps)
        return total / self.n_scale


def rss_loss(x_pred: torch.Tensor, x_true: torch.Tensor, idx=None,
             fft_min: int = 256, fft_max: int = 2048, n_scale: int = 4,
             generator: torch.Generator | None = None) -> torch.Tensor:
    return RSSLoss(fft_min, fft_max, n_scale)(x_pred, x_true, idx, generator)


def mel_snr(gt_mel: torch.Tensor, pred_mel: torch.Tensor) -> torch.Tensor:
    """10 log10(mean(gt^2) / var(gt - pred))."""
    err = gt_mel - pred_mel
    return 10.0 * torch.log10(torch.mean(gt_mel ** 2)
                              / torch.var(err, correction=0))


def mel_si_snr(gt_mel: torch.Tensor, pred_mel: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SNR."""
    scale = torch.sum(gt_mel * pred_mel) / torch.sum(gt_mel ** 2)
    err = gt_mel - scale * pred_mel
    return 10.0 * torch.log10(torch.mean(gt_mel ** 2)
                              / torch.var(err, correction=0))


def mel_psnr(gt_mel: torch.Tensor, pred_mel: torch.Tensor) -> torch.Tensor:
    """10 log10(max(gt)^2 / mse)."""
    mse = torch.mean((gt_mel - pred_mel) ** 2)
    return 10.0 * torch.log10(torch.max(gt_mel) ** 2 / mse)
