"""Conv-only conformer encoder (mirrors ddsp_svc_tpu/models/conformer.py:
ConformerConvModule, with or without its leading LayerNorm, and
CFNEncoderLayer, ConformerNaiveEncoder with conv_only=True, use_norm=False,
no dropout at inference).

Time-sharded (``parallel/``): ``edge_mask`` (B, T, 1), 0 on the frames of
a haloed block that lie outside the utterance, zeroes the GLU's output
before each depthwise conv, so the conv sees the whole utterance's zero
padding at the global edges (JAX conformer.py:39-63, 115-150)."""
from __future__ import annotations

import torch
import torch.nn as nn

from .nn import Conv1d, LayerNorm, glu, silu


def calc_same_padding(kernel_size: int) -> int:
    """Symmetric 'same' padding; the conformers here use odd kernels only."""
    if kernel_size % 2 == 0:
        raise ValueError(f"odd kernel sizes only, got {kernel_size}")
    return kernel_size // 2


class ConformerConvModule(nn.Module):
    """LayerNorm (``use_norm``, as PCmer) -> 1x1 conv -> GLU -> depthwise k
    -> SiLU -> 1x1 conv (JAX LayerNorm_0, Conv1d_0, Conv1d_1, Conv1d_2 are
    ``norm``, ``conv1``, ``depthwise``, ``conv2`` here)."""

    def __init__(self, dim: int, expansion_factor: int = 2,
                 kernel_size: int = 31, use_norm: bool = False):
        super().__init__()
        inner = dim * expansion_factor
        self.norm = LayerNorm(dim) if use_norm else None  # eps 1e-5
        self.conv1 = Conv1d(dim, inner * 2, 1)
        self.depthwise = Conv1d(inner, inner, kernel_size,
                                padding=calc_same_padding(kernel_size),
                                groups=inner)
        self.conv2 = Conv1d(inner, dim, 1)

    def forward(self, x: torch.Tensor,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        x = glu(self.conv1(x))
        if edge_mask is not None:
            x = x * edge_mask.to(x.dtype)
        return self.conv2(silu(self.depthwise(x)))


class CFNEncoderLayer(nn.Module):
    def __init__(self, dim_model: int):
        super().__init__()
        self.conformer = ConformerConvModule(dim_model)

    def forward(self, x: torch.Tensor,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        return x + self.conformer(x, edge_mask)


class ConformerNaiveEncoder(nn.Module):
    def __init__(self, num_layers: int, dim_model: int):
        super().__init__()
        self.layers = nn.ModuleList(
            CFNEncoderLayer(dim_model) for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, edge_mask)
        return x
