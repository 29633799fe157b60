"""CREPE pitch estimator, torchcrepe's 'full' model (mirrors
ddsp_svc_tpu/features/crepe.py: ``Crepe``, ``weighted_argmax_f0`` and
``CrepeInfer``).

Six blocks of [conv over the 1024-sample frame, eval BatchNorm, ReLU,
max-pool 2] with channels (1024, 128, 128, 128, 256, 512), kernel 512 at
stride 4 padded (254, 254), then kernel 64 padded (31, 32); the (B, 512, 4)
output flattened H-major to 2048, a Dense of 360 and a sigmoid. The convs
are ``Conv2d`` with (k, 1) kernels on (B, C, 1024, 1), as the JAX module's
(k, 1) NHWC convs, so the converted kernels map by a permutation.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.nn import BatchNorm
from ..ops.resample import resample
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
WINDOW_SIZE = 1024
N_BINS = 360
CENTS_OFFSET = 1997.3794084376191

FULL_CHANNELS = (1024, 128, 128, 128, 256, 512)
BATCH_FRAMES = 2048  # frames a forward: bounds the activations' memory


class Crepe(nn.Module):
    """Normalised frames (B, 1024) -> salience (B, 360)."""

    def __init__(self):
        super().__init__()
        ins = (1,) + FULL_CHANNELS[:-1]
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, (512, 1) if n == 0 else (64, 1),
                      stride=(4, 1) if n == 0 else (1, 1))
            for n, (i, o) in enumerate(zip(ins, FULL_CHANNELS)))
        self.bns = nn.ModuleList(BatchNorm(c) for c in FULL_CHANNELS)
        self.classifier = nn.Linear(4 * FULL_CHANNELS[-1], N_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :, None]  # (B, 1, 1024, 1)
        for n, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.pad(x, (0, 0, 254, 254) if n == 0 else (0, 0, 31, 32))
            x = F.max_pool2d(F.relu(bn(conv(x))), (2, 1))
        b = x.shape[0]
        x = x[..., 0].transpose(1, 2).reshape(b, -1)  # H-major
        return torch.sigmoid(self.classifier(x))


def weighted_argmax_f0(salience: np.ndarray, fmin: float | None = None,
                       fmax: float | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(T, 360) -> (f0 Hz, periodicity): the bins outside [fmin, fmax]
    zeroed first (as torchcrepe.predict does), then the weighted mean cents
    over the +-4 bins around the argmax; periodicity is the peak."""
    idx = np.arange(N_BINS)[None, :]
    cents = idx * 20 + CENTS_OFFSET
    if fmin is not None or fmax is not None:
        freq = 10.0 * 2.0 ** (cents / 1200.0)
        keep = np.ones(N_BINS, bool)[None, :]
        if fmin is not None:
            keep &= freq >= fmin
        if fmax is not None:
            keep &= freq <= fmax
        salience = np.where(keep, salience, 0.0)
    center = salience.argmax(axis=1, keepdims=True)
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_BINS)
    mask = (idx >= start) & (idx < end)
    w = salience * mask
    c = (w * cents).sum(axis=1) / np.maximum(w.sum(axis=1), 1e-9)
    f0 = 10.0 * 2.0 ** (c / 1200.0)
    periodicity = salience.max(axis=1)
    return f0.astype(np.float32), periodicity.astype(np.float32)


class CrepeInfer:
    """Audio -> (f0, periodicity) on the 5 ms grid: 16 kHz, centred 1024
    frames (zero-padded), each normalised to zero mean and unit deviation on
    the host, the net on ``device`` (the CUDA card unless told). ``state``
    is the port's state dict (``io/jax_params.crepe_state_dict``)."""

    def __init__(self, state: dict, hop_length: int = 80,
                 device: str | torch.device | None = None):
        from ..io.jax_params import load_state

        self.device = resolve_device(device)
        self.hop_length = hop_length
        self.model = load_state(Crepe().to(self.device).eval(), state)

    def frames(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE
               ) -> np.ndarray:
        """1-D audio -> the normalised frames (n_frames, 1024) on the host."""
        x = torch.as_tensor(np.asarray(audio, np.float32))[None]
        if sample_rate != SAMPLE_RATE:
            x = resample(x.to(self.device), sample_rate, SAMPLE_RATE)
        a = x[0].cpu().numpy()
        n_frames = len(a) // self.hop_length + 1
        padded = np.pad(a, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
        idx = (np.arange(n_frames)[:, None] * self.hop_length
               + np.arange(WINDOW_SIZE)[None, :])
        frames = padded[np.minimum(idx, len(padded) - 1)]
        frames = frames - frames.mean(axis=1, keepdims=True)
        return frames / np.maximum(frames.std(axis=1, keepdims=True), 1e-10)

    @torch.no_grad()
    def salience(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE
                 ) -> torch.Tensor:
        """1-D audio -> the net's salience (n_frames, 360) on the device,
        ``BATCH_FRAMES`` frames a forward (each frame's salience is its
        own)."""
        frames = torch.as_tensor(self.frames(audio, sample_rate), device=self.device)
        return torch.cat([self.model(chunk)
                          for chunk in frames.split(BATCH_FRAMES)])

    def infer_from_audio(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
                         fmin: float | None = None, fmax: float | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
        salience = self.salience(audio, sample_rate).cpu().numpy()
        return weighted_argmax_f0(salience, fmin=fmin, fmax=fmax)
