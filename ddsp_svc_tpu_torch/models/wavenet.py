"""The WaveNet noise predictor of the Diffusion and DiffusionNew cascades
and the diffusion-step embedding (mirrors ddsp_svc_tpu/models/wavenet.py:
``sinusoidal_pos_emb``, ``WaveNetResidualBlock``, ``WaveNet``).

Feature-last (B, T, C) throughout. Its convs are plain ``F.conv1d``: the
JAX package has no Pallas kernel for them. Time-sharded
(``parallel/stream_cascade.py``): ``edge_mask`` (B, T, 1) zeroes each
block's input outside the utterance before its dilated conv, the whole
utterance's zero padding (JAX wavenet.py:36-43, 68-84).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .nn import Conv1d, Dense, sigmoid, softplus, weak


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) float steps -> (B, dim) = [sin(t w), cos(t w)],
    w_k = exp(-k log(10000) / (dim/2 - 1))."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    levels = torch.arange(half, dtype=t.dtype, device=t.device)
    freqs = torch.exp(levels * weak(-scale, levels))
    emb = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class WaveNetResidualBlock(nn.Module):
    """Gated residual block: x (B, T, C), cond (B, T, H), step (B, C) ->
    ((x + residual) / sqrt 2, skip)."""

    def __init__(self, residual_channels: int, n_hidden: int, dilation: int = 1):
        super().__init__()
        c = residual_channels
        self.diffusion_projection = Dense(c, c)
        self.dilated_conv = Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.conditioner_projection = Conv1d(n_hidden, 2 * c, 1)
        self.output_projection = Conv1d(c, 2 * c, 1)

    def forward(self, x, cond, diffusion_step, edge_mask=None):
        y = x + self.diffusion_projection(diffusion_step)[:, None, :]
        if edge_mask is not None:
            y = y * edge_mask.to(y.dtype)
        y = self.dilated_conv(y) + self.conditioner_projection(cond)
        gate, filt = y.chunk(2, dim=-1)
        y = self.output_projection(sigmoid(gate) * torch.tanh(filt))
        residual, skip = y.chunk(2, dim=-1)
        return (x + residual) / weak(math.sqrt(2.0), x), skip


class WaveNet(nn.Module):
    """spec (B, T, M), diffusion_step (B,) float, cond (B, T, H) -> the
    predicted noise (B, T, M)."""
    ZERO_INIT = ("output_projection",)  # zero weights at training init

    def __init__(self, in_dims: int = 128, n_layers: int = 20,
                 n_chans: int = 384, n_hidden: int = 256, remat: bool = False):
        super().__init__()
        self.n_chans, self.remat = n_chans, remat
        self.input_projection = Conv1d(in_dims, n_chans, 1)
        self.mlp_0 = Dense(n_chans, 4 * n_chans)
        self.mlp_1 = Dense(4 * n_chans, n_chans)
        self.layers = nn.ModuleList(WaveNetResidualBlock(n_chans, n_hidden)
                                    for _ in range(n_layers))
        self.skip_projection = Conv1d(n_chans, n_chans, 1)
        self.output_projection = Conv1d(n_chans, in_dims, 1)

    def forward(self, spec, diffusion_step, cond, edge_mask=None):
        x = F.relu(self.input_projection(spec))
        step = sinusoidal_pos_emb(diffusion_step.to(x.dtype), self.n_chans)
        step = self.mlp_0(step)
        step = self.mlp_1(step * torch.tanh(softplus(step)))  # Mish
        skips = 0.0
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x, skip = checkpoint(layer, x, cond, step, edge_mask,
                                     use_reentrant=False, preserve_rng_state=False)
            else:
                x, skip = layer(x, cond, step, edge_mask)
            skips = skips + skip
        x = F.relu(self.skip_projection(
            skips / weak(math.sqrt(len(self.layers)), skips)))
        return self.output_projection(x)
