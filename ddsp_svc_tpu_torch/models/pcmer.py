"""PCmer: Performer (FAVOR+) self-attention + conformer conv module, the
decoder of the legacy DDSP models (mirrors ddsp_svc_tpu/models/pcmer.py:
``softmax_kernel``, ``linear_attention``, ``FAVORSelfAttention``,
``PCmerLayer``, ``PCmer``, with ``pcmer_norm``).

Time-sharded (``parallel/``): ``frame_mask`` (B, T, 1) zeroes the halo
frames' keys and values, so each global frame counts once, and ``group``
(a ``parallel.mesh.TimeGroup``) sums the attention's only cross-frame
quantities, ``k_sum`` and the M x E ``context``, over the ranks; then the
attention needs no halo (JAX pcmer.py:64-75, 136-173). ``edge_mask`` goes
to each layer's conformer conv (models/conformer.py).

The FAVOR+ projection matrix is a buffer (``attn.projection_matrix``) that
comes with the checkpoint (the JAX ``buffers`` collection); the port never
redraws it. ``gaussian_orthogonal_random_matrix`` only fills it for a
random-init run, from an explicit generator (``models/nn.random_init_``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .conformer import ConformerConvModule
from .nn import Dense, LayerNorm, weak


def gaussian_orthogonal_random_matrix(nb_rows: int, nb_cols: int,
                                      generator: torch.Generator) -> torch.Tensor:
    """Stacked orthogonal blocks (Q^T of a gaussian's QR), rows scaled by
    the norms of gaussian rows: (nb_rows, nb_cols), on the CPU."""
    n_full = nb_rows // nb_cols
    blocks = []
    for _ in range(n_full):
        q, _ = torch.linalg.qr(torch.randn((nb_cols, nb_cols), generator=generator))
        blocks.append(q.T)
    rem = nb_rows - n_full * nb_cols
    if rem > 0:
        q, _ = torch.linalg.qr(torch.randn((nb_cols, nb_cols), generator=generator))
        blocks.append(q.T[:rem])
    multiplier = torch.linalg.norm(
        torch.randn((nb_rows, nb_cols), generator=generator), dim=1)
    return multiplier[:, None] * torch.cat(blocks, dim=0)


def softmax_kernel(data: torch.Tensor, projection_matrix: torch.Tensor,
                   is_query: bool, eps: float = 1e-4) -> torch.Tensor:
    """FAVOR+ positive features: data (B, H, N, D), projection (M, D) ->
    (B, H, N, M)."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection_matrix.shape[0] ** -0.5
    # a bf16 data meets the f32 projection in f32, as JAX promotes it
    data_dash = torch.einsum("bhnd,md->bhnm",
                             (weak(normalizer, data) * data).to(projection_matrix.dtype),
                             projection_matrix)
    diag = (torch.sum(data ** 2, dim=-1, keepdim=True) / 2.0
            * weak(normalizer ** 2, data))
    if is_query:
        return ratio * (torch.exp(
            data_dash - diag - torch.amax(data_dash, dim=-1, keepdim=True)) + eps)
    return ratio * torch.exp(data_dash - diag + eps)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Non-causal linear attention over features q, k (B, H, N, M) and
    values v (B, H, N, E) -> (B, H, N, E); ``group`` sums k_sum and the
    context over the time group's ranks."""
    k_sum = torch.sum(k, dim=-2)
    context = torch.einsum("bhnm,bhne->bhme", k, v.to(k.dtype))
    if group is not None:
        k_sum, context = group.psum(k_sum), group.psum(context)
    d_inv = 1.0 / (torch.einsum("bhnm,bhm->bhn", q, k_sum) + 1e-8)
    return torch.einsum("bhme,bhnm,bhn->bhne", context, q, d_inv)


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    """||t|| over the last axis, kept; on bf16 as JAX computes
    ``jnp.linalg.norm``: squares and their sum's result rounded to bf16
    (the sum itself in f32), then the square root."""
    if t.dtype == torch.float32:
        return torch.linalg.norm(t, dim=-1, keepdim=True)
    return torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))


class FAVORSelfAttention(nn.Module):
    """Dense q/k/v projections to heads x dim_head (64 regardless of dim,
    as the reference), FAVOR+ linear attention, output projection."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 pcmer_norm: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.pcmer_norm = heads, dim_head, pcmer_norm
        inner = heads * dim_head
        self.nb_features = int(dim_head * math.log(dim_head))
        self.to_q = Dense(dim, inner)
        self.to_k = Dense(dim, inner)
        self.to_v = Dense(dim, inner)
        self.to_out = Dense(inner, dim)
        self.register_buffer("projection_matrix",
                             torch.zeros(self.nb_features, dim_head))

    def redraw_projection_matrix(self, generator: torch.Generator) -> None:
        """Fill the buffer for a random-init run (never on a loaded model)."""
        with torch.no_grad():
            self.projection_matrix.copy_(gaussian_orthogonal_random_matrix(
                self.nb_features, self.dim_head, generator))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None,
                group=None) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (self.to_q(x), self.to_k(x), self.to_v(x)))
        if self.pcmer_norm:
            q = q / (_l2norm(q) + weak(1e-8, q))
            k = k / (_l2norm(k) + weak(1e-8, k))
        q = softmax_kernel(q, self.projection_matrix, is_query=True)
        k = softmax_kernel(k, self.projection_matrix, is_query=False)
        if frame_mask is not None:
            m = frame_mask.reshape(b, 1, n, 1)
            k, v = k * m.to(k.dtype), v * m.to(v.dtype)
        out = linear_attention(q, k, v, group)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class PCmerLayer(nn.Module):
    def __init__(self, dim_model: int, num_heads: int, pcmer_norm: bool = False):
        super().__init__()
        self.norm = LayerNorm(dim_model)  # eps 1e-5, as JAX
        self.attn = FAVORSelfAttention(dim_model, num_heads, pcmer_norm=pcmer_norm)
        self.conformer = ConformerConvModule(dim_model, use_norm=True)

    def forward(self, x: torch.Tensor, frame_mask=None, group=None,
                edge_mask=None) -> torch.Tensor:
        x = x + self.attn(self.norm(x), frame_mask, group)
        return x + self.conformer(x, edge_mask)


class PCmer(nn.Module):
    def __init__(self, num_layers: int, num_heads: int, dim_model: int,
                 pcmer_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            PCmerLayer(dim_model, num_heads, pcmer_norm) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, frame_mask=None, group=None,
                edge_mask=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, frame_mask, group, edge_mask)
        return x
