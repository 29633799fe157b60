"""FCPE pitch estimator, torchfcpe's CFNaiveMelPE (mirrors
ddsp_svc_tpu/features/fcpe.py: ``CFNaiveMelPE``, ``local_argmax_f0`` and
``FCPEInfer``).

log-mel (B, T, 128; 16 kHz, hop 160) -> Conv1d k3 -> GroupNorm(4) ->
LeakyReLU(0.01) -> Conv1d k3 -> the conv-only ``ConformerNaiveEncoder``
(the stock layers, as the JAX package runs this encoder, not K3) ->
LayerNorm -> the weight-normed Dense of 360 -> sigmoid; decoded by the
local argmax on the 10 ms grid.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.conformer import ConformerNaiveEncoder
from ..models.nn import Conv1d, GroupNorm, LayerNorm, WNLinear
from ..ops.mel import LogMelSpectrogram
from ..ops.resample import resample
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
HOP = 160  # the 10 ms grid
F0_MIN = 32.70
F0_MAX = 1975.5
N_BINS = 360


def f0_to_cent(f0):
    return 1200.0 * np.log2(np.asarray(f0, np.float64) / 10.0)


def cent_table() -> np.ndarray:
    return np.linspace(f0_to_cent(F0_MIN), f0_to_cent(F0_MAX), N_BINS).astype(
        np.float32)


class CFNaiveMelPE(nn.Module):
    """mel (B, T, 128) -> probabilities (B, T, 360)."""

    def __init__(self, hidden: int = 512, n_layers: int = 6, n_mels: int = 128,
                 out_dims: int = N_BINS):
        super().__init__()
        self.input_conv0 = Conv1d(n_mels, hidden, 3, padding=1)
        self.input_norm = GroupNorm(4, hidden)
        self.input_conv1 = Conv1d(hidden, hidden, 3, padding=1)
        self.net = ConformerNaiveEncoder(n_layers, hidden)
        self.norm = LayerNorm(hidden)
        self.output_proj = WNLinear(hidden, out_dims)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.input_norm(self.input_conv0(mel)), 0.01)
        x = self.net(self.input_conv1(x))
        return torch.sigmoid(self.output_proj(self.norm(x)))


def local_argmax_f0(probs: np.ndarray, threshold: float = 0.006) -> np.ndarray:
    """The probability-weighted cents over the +-4 bins around the argmax,
    the window's indices clamped to the edge bins (torchfcpe's gather;
    RMVPE's window is cut instead); unvoiced (0) where the peak is at or
    below ``threshold``."""
    table = cent_table()
    idx = probs.argmax(axis=-1)
    local = np.clip(idx[:, None] + np.arange(-4, 5)[None, :], 0, N_BINS - 1)
    t_idx = np.arange(len(idx))[:, None]
    w = probs[t_idx, local]
    cents = (table[local] * w).sum(-1) / np.maximum(w.sum(-1), 1e-12)
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    conf = probs.max(axis=-1)
    return np.where(conf > threshold, f0, 0.0).astype(np.float32)


class FCPEInfer:
    """Audio -> f0 on the 10 ms grid, the net (the published 512 x 6) on
    ``device`` (the CUDA card unless told). ``state`` is the port's state
    dict (``io/jax_params.fcpe_state_dict``)."""

    def __init__(self, state: dict, device: str | torch.device | None = None):
        from ..io.jax_params import load_state

        self.device = resolve_device(device)
        self.net = load_state(CFNaiveMelPE().to(self.device).eval(), state)
        self.mel = LogMelSpectrogram(sr=SAMPLE_RATE, n_mels=128, n_fft=1024,
                                     win_size=1024, hop_length=HOP, fmin=0.0,
                                     fmax=8000.0).to(self.device)

    @torch.no_grad()
    def salience(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE
                 ) -> torch.Tensor:
        """1-D audio -> the net's probabilities (len // 160 + 1, 360) at
        16 kHz, on the device; the mel's last frame repeated to that count
        (torchfcpe's edge pad)."""
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        if sample_rate != SAMPLE_RATE:
            x = resample(x, sample_rate, SAMPLE_RATE)
        n_frames = x.shape[1] // HOP + 1
        mel = self.mel(x).transpose(1, 2)  # (1, T, 128)
        if mel.shape[1] < n_frames:
            mel = F.pad(mel.transpose(1, 2), (0, n_frames - mel.shape[1]),
                        mode="replicate").transpose(1, 2)
        return self.net(mel[:, :n_frames])[0]

    def infer_from_audio(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
                         threshold: float = 0.006) -> np.ndarray:
        probs = self.salience(audio, sample_rate).cpu().numpy()
        return local_argmax_f0(probs, threshold=threshold)
