"""NaiveV2Diff: the conv-only conformer denoiser of DiffusionFast (mirrors
ddsp_svc_tpu/models/naive_v2_diff.py with use_mlp=False, conv_only=True,
no norm, no wavenet_like). Each layer runs through kernel K3
(ops/cuda_conformer.conformer_layer), or with ``trunk_bf16`` through B3,
K3's bf16 class (``conformer_layer_bf16``; JAX ``use_pallas=True,
pallas_mxu_bf16=True``). ``remat`` (JAX ``remat=True``, ``nn.remat`` per
layer) recomputes each layer's forward in the backward
(``torch.utils.checkpoint``, non-reentrant), so the layer's kernel
launches again there. A bf16 model (``set_compute_dtype``, JAX
``dtype=bfloat16``) carries bf16 activations through the trunk, and each
layer runs through B5 (``conformer_layer_bf16_io``), as JAX's fused layer
runs on a bf16 x. No dropout fires in this trunk: JAX builds it conv-only
with conv_dropout 0.0.

Time-sharded (``parallel/stream_cascade.py``): with an ``edge_mask`` (B, T,
1), 0 on the frames of a haloed block outside the utterance, a layer takes
JAX's stock chain instead of a kernel, as JAX's dispatch sends a masked
layer away from its fused kernel (naive_v2_diff.py:62-69, 88-90): the step
and condition projections added to x, then ``ConformerConvModule`` with the
mask before its depthwise conv, all from the layer's own modules. JAX has
no masked kernel, so neither has the port."""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.cuda_conformer import (bf16_gemm_weights, conformer_layer,
                                   conformer_layer_bf16,
                                   conformer_layer_bf16_io)
from .conformer import ConformerConvModule
from .nn import Conv1d, Dense, gelu
from .wavenet import sinusoidal_pos_emb


class NaiveV2DiffLayer(nn.Module):
    def __init__(self, dim_model: int, dim_cond: int, expansion_factor: int = 2,
                 kernel_size: int = 31, trunk_bf16: bool = False):
        super().__init__()
        self.trunk_bf16 = trunk_bf16
        self._bf16 = (None, None)  # (the weights' versions, their bf16 copies)
        self.diffusion_step_projection = Conv1d(dim_model, dim_model, 1)
        self.condition_projection = Conv1d(dim_cond, dim_model, 1)
        self.conformer = ConformerConvModule(dim_model, expansion_factor,
                                             kernel_size)

    def kernel_weights(self) -> tuple:
        """(Wc, bc, W1, b1, wd, bd, W2, b2) in the kernel's torch layout:
        the 1x1 conv weights squeezed to (out, in), depthwise (I, k)."""
        cm = self.conformer
        return (self.condition_projection.weight[:, :, 0],
                self.condition_projection.bias,
                cm.conv1.weight[:, :, 0], cm.conv1.bias,
                cm.depthwise.weight[:, 0, :], cm.depthwise.bias,
                cm.conv2.weight[:, :, 0], cm.conv2.bias)

    def bf16_weights(self, weights) -> tuple:
        """B3's bf16 copies of Wc, W1, W2, rounded once and kept until a
        weight changes: the key is each parameter's storage, device and
        version counter, which every in-place update (an optimizer step,
        ``load_state_dict``) advances, so training never reads stale
        copies."""
        params = (self.condition_projection.weight, self.conformer.conv1.weight,
                  self.conformer.conv2.weight)
        key = tuple((p.data_ptr(), p.device, p._version) for p in params)
        if self._bf16[0] != key:
            self._bf16 = (key, bf16_gemm_weights(weights))
        return self._bf16[1]

    def forward(self, x, condition, diffusion_step, edge_mask=None):
        """x (B, T, C), condition (B, T, Hc), diffusion_step (B, 1, C);
        ``edge_mask`` (B, T, 1) takes the masked stock chain."""
        if edge_mask is not None:
            h = (x + self.diffusion_step_projection(diffusion_step)
                 + self.condition_projection(condition))
            return self.conformer(h, edge_mask) + x
        # the step projection of the (B, 1, C) embedding stays outside the
        # kernel, as in JAX, in f32 (a bf16 embedding times the f32 folded
        # weights, naive_v2_diff.py:78-81)
        step_vec = self.diffusion_step_projection(diffusion_step,
                                                  torch.float32)[:, 0, :]
        weights = self.kernel_weights()
        if x.dtype == torch.bfloat16:
            packed = self.bf16_weights(weights) if x.is_cuda else None
            return conformer_layer_bf16_io(x, condition, step_vec.contiguous(),
                                           weights, packed)
        if self.trunk_bf16:
            packed = self.bf16_weights(weights) if x.is_cuda else None
            return conformer_layer_bf16(x, condition, step_vec.contiguous(),
                                        weights, packed)
        return conformer_layer(x, condition, step_vec.contiguous(), weights)


class NaiveV2Diff(nn.Module):
    ZERO_INIT = ("output_projection",)  # zero weights at training init

    def __init__(self, mel_channels: int = 128, dim: int = 512,
                 condition_dim: int = 128, num_layers: int = 6,
                 mlp_factor: int = 4, expansion_factor: int = 2,
                 kernel_size: int = 31, trunk_bf16: bool = False,
                 remat: bool = False):
        super().__init__()
        self.dim, self.remat = dim, remat
        self.input_projection = Conv1d(mel_channels, dim, 1)
        self.diff_emb_0 = Dense(dim, dim * mlp_factor)
        self.diff_emb_1 = Dense(dim * mlp_factor, dim)
        self.layers = nn.ModuleList(
            NaiveV2DiffLayer(dim, condition_dim, expansion_factor, kernel_size,
                             trunk_bf16)
            for _ in range(num_layers))
        self.output_projection = Conv1d(dim, mel_channels, 1)

    def forward(self, spec, diffusion_step, cond, edge_mask=None):
        """spec (B, T, M), diffusion_step (B,) float, cond (B, T, Hc) ->
        (B, T, M); ``edge_mask`` (B, T, 1): a time-sharded block's."""
        x = gelu(self.input_projection(spec)).contiguous()
        step = sinusoidal_pos_emb(diffusion_step.to(x.dtype), self.dim)
        step = self.diff_emb_1(gelu(self.diff_emb_0(step)))[:, None, :]
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cond, step, edge_mask,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, cond, step, edge_mask)
        return self.output_projection(x)
