"""RMVPE pitch estimator (mirrors ddsp_svc_tpu/features/rmvpe.py: E2E0,
its decoders and the ``RMVPE`` inference wrapper).

The net runs channels-first, (B, C, H, W) with H the frames and W the 128
mel bins, where the JAX module is NHWC; eval-mode BatchNorm reads the JAX
``batch_stats``. The BiGRU is ``torch.nn.GRU(bidirectional=True)``: the
JAX package runs it as two ``nn.scan`` passes of flax's ``GRUCell``,
outside any Pallas kernel. The decoders (local average and Viterbi) are
host numpy copies. Weights come from a converted tree through
``io/jax_params.rmvpe_state_dict``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.nn import BatchNorm, ConvTranspose2d
from ..ops.mel import mel_filterbank
from ..ops.resample import resample
from ..ops.spectral import stft
from ..ops.window import hann_window
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = 8000
WINDOW_LENGTH = 1024
CONST = 1997.3794084376191


class ConvBlockRes(nn.Module):
    """conv3x3 - BN - ReLU, twice, plus the input (through a 1x1 conv with
    bias when the channel count changes)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(out_channels)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return y + (x if self.shortcut is None else self.shortcut(x))


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int,
                 pool: bool = True):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConvBlockRes(in_channels if i == 0 else out_channels, out_channels)
            for i in range(n_blocks))
        self.pool = pool

    def forward(self, x: torch.Tensor):
        for block in self.blocks:
            x = block(x)
        if self.pool:
            return x, F.avg_pool2d(x, 2)
        return x


class ResDecoderBlock(nn.Module):
    """ConvTranspose2d(k3, s2, p1, output_padding 1): exactly twice the
    size; BN, ReLU, the skip concatenated after, then the blocks."""

    def __init__(self, in_channels: int, out_channels: int, n_blocks: int):
        super().__init__()
        self.deconv = ConvTranspose2d(in_channels, out_channels, 3, stride=2,
                                      padding=1, output_padding=1, bias=False)
        self.bn1 = BatchNorm(out_channels)
        self.blocks = nn.ModuleList(
            ConvBlockRes(2 * out_channels if i == 0 else out_channels, out_channels)
            for i in range(n_blocks))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([F.relu(self.bn1(self.deconv(x))), skip], dim=1)
        for block in self.blocks:
            x = block(x)
        return x


class DeepUnet0(nn.Module):
    """Five encoders (16 ... 256 channels, 2x2 average pools), four
    intermediate blocks at 512, five decoders back to 16."""

    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5,
                 inter_layers: int = 4, en_out_channels: int = 16):
        super().__init__()
        self.in_bn = BatchNorm(1)
        ch, in_ch = en_out_channels, 1
        self.enc = nn.ModuleList()
        for _ in range(en_de_layers):
            self.enc.append(ResEncoderBlock(in_ch, ch, n_blocks))
            in_ch, ch = ch, ch * 2
        self.inter = nn.ModuleList()
        for _ in range(inter_layers):
            self.inter.append(ResEncoderBlock(in_ch, ch, n_blocks, pool=False))
            in_ch = ch
        self.dec = nn.ModuleList()
        for _ in range(en_de_layers):
            self.dec.append(ResDecoderBlock(in_ch, in_ch // 2, n_blocks))
            in_ch //= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_bn(x)
        skips = []
        for enc in self.enc:
            skip, x = enc(x)
            skips.append(skip)
        for inter in self.inter:
            x = inter(x)
        for i, dec in enumerate(self.dec):
            x = dec(x, skips[-1 - i])
        return x


class E2E0(nn.Module):
    """log-mel (B, T, 128) -> salience (B, T, 360): the U-Net, a 3x3 conv to
    3 channels flattened channel-major to 384, a BiGRU of 256 a direction
    (``n_gru`` 1; none at 0), a Dense of 360 and a sigmoid."""

    def __init__(self, n_blocks: int = 4, n_gru: int = 1):
        super().__init__()
        self.unet = DeepUnet0(n_blocks)
        self.cnn = nn.Conv2d(16, 3, 3, padding=1)
        self.gru = (nn.GRU(3 * N_MELS, 256, batch_first=True, bidirectional=True)
                    if n_gru else None)
        self.fc = nn.Linear(512 if n_gru else 3 * N_MELS, N_CLASS)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.cnn(self.unet(mel[:, None]))  # (B, 3, T, 128)
        b, _, t, _ = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, t, 3 * N_MELS)
        if self.gru is not None:
            x = self.gru(x)[0]
        return torch.sigmoid(self.fc(x))


def to_local_average_f0(hidden: np.ndarray, thred: float = 0.03,
                        center: np.ndarray | None = None) -> np.ndarray:
    """(T, 360) salience -> (T,) f0 in Hz: the salience-weighted mean cents
    over the +-4 bins around ``center`` (the argmax unless given, e.g. the
    Viterbi path; the window cut at the edges), 10 * 2^(cents / 1200), 0
    where the peak salience is below ``thred``."""
    idx = np.arange(N_CLASS)[None, :]
    idx_cents = idx * 20 + CONST
    if center is None:
        center = hidden.argmax(axis=1, keepdims=True)
    else:
        center = np.asarray(center, np.int64).reshape(-1, 1)
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_CLASS)
    mask = (idx >= start) & (idx < end)
    weights = hidden * mask
    product_sum = (weights * idx_cents).sum(axis=1)
    weight_sum = weights.sum(axis=1)
    cents = product_sum / (weight_sum + (weight_sum == 0))
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    f0[hidden.max(axis=1) < thred] = 0.0
    return f0.astype(np.float32)


_VITERBI_TRANSITION: np.ndarray | None = None


def _viterbi_transition() -> np.ndarray:
    """Row-normalised triangular pitch-step prior: p(j | i) proportional to
    max(30 - |i - j|, 0)."""
    global _VITERBI_TRANSITION
    if _VITERBI_TRANSITION is None:
        d = np.abs(np.arange(N_CLASS)[:, None] - np.arange(N_CLASS)[None, :])
        t = np.maximum(30 - d, 0).astype(np.float64)
        _VITERBI_TRANSITION = t / t.sum(axis=1, keepdims=True)
    return _VITERBI_TRANSITION


def viterbi_path(prob: np.ndarray, transition: np.ndarray) -> np.ndarray:
    """The most likely state path (librosa.sequence.viterbi): ``prob``
    (n_states, T) observation likelihoods, ``transition`` row-stochastic,
    a uniform start -> (T,) int64."""
    tiny = np.finfo(np.float64).tiny
    log_trans = np.log(transition + tiny)
    log_prob = np.log(prob.T + tiny)
    n_states, t_len = prob.shape
    value = np.empty((t_len, n_states))
    ptr = np.empty((t_len, n_states), dtype=np.int64)
    value[0] = log_prob[0] - np.log(n_states)
    for t in range(1, t_len):
        trans_out = value[t - 1][:, None] + log_trans  # (from, to)
        ptr[t] = np.argmax(trans_out, axis=0)
        value[t] = log_prob[t] + trans_out[ptr[t], np.arange(n_states)]
    path = np.empty(t_len, dtype=np.int64)
    path[-1] = np.argmax(value[-1])
    for t in range(t_len - 2, -1, -1):
        path[t] = ptr[t + 1][path[t + 1]]
    return path


def to_viterbi_f0(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """(T, 360) salience -> (T,) f0 in Hz around the Viterbi-smoothed bin
    path."""
    prob = hidden.T.astype(np.float64)
    prob = prob / prob.sum(axis=0)
    path = viterbi_path(prob, _viterbi_transition())
    return to_local_average_f0(hidden, thred=thred, center=path)


class RMVPE:
    """Audio -> f0 on the 10 ms grid: resample to 16 kHz, a centred reflect
    STFT (window 1024, hop 160), the HTK mel, log with a 1e-5 clip, the
    frames padded to a multiple of 32, the net on ``device`` (the CUDA card
    unless told), the decoder on the host. ``state`` is the port's state
    dict (``io/jax_params.rmvpe_state_dict``)."""

    def __init__(self, state: dict, hop_length: int = 160,
                 device: str | torch.device | None = None):
        from ..io.jax_params import load_state

        self.device = resolve_device(device)
        self.hop_length = hop_length
        self.model = load_state(E2E0().to(self.device).eval(), state)
        self.mel_basis = torch.from_numpy(mel_filterbank(
            SAMPLE_RATE, WINDOW_LENGTH, N_MELS, MEL_FMIN, MEL_FMAX,
            htk=True)).to(self.device)
        self.window = torch.from_numpy(hann_window(WINDOW_LENGTH)).to(self.device)

    def mel_from_audio16k(self, audio16k: torch.Tensor) -> torch.Tensor:
        """(B, L) 16 kHz audio -> log-mel (B, T, 128)."""
        mag = stft(audio16k, WINDOW_LENGTH, self.hop_length,
                   window=self.window).abs()
        mel = torch.matmul(self.mel_basis, mag)
        return torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2)

    @torch.no_grad()
    def salience(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE
                 ) -> torch.Tensor:
        """1-D audio -> the net's salience (T, 360) on the device."""
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        if sample_rate != SAMPLE_RATE:
            x = resample(x, sample_rate, SAMPLE_RATE)
        mel = self.mel_from_audio16k(x)
        n_frames = mel.shape[1]
        pad_to = 32 * ((n_frames - 1) // 32 + 1)
        mel = F.pad(mel, (0, 0, 0, pad_to - n_frames))
        return self.model(mel)[0, :n_frames]

    def infer_from_audio(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE,
                         thred: float = 0.03, use_viterbi: bool = False
                         ) -> np.ndarray:
        hidden = self.salience(audio, sample_rate).cpu().numpy()
        decode = to_viterbi_f0 if use_viterbi else to_local_average_f0
        return decode(hidden, thred=thred)
