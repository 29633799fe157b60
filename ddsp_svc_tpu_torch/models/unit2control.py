"""Unit2Control: units + f0/phase/volume/speaker -> named control tensors
(mirrors ddsp_svc_tpu/models/unit2control.py with its flags and defaults:
a conv stack (``use_conv_stack``) or one conv, additive embeddings (the
speaker's, or a speaker mix), a
3-layer decoder -- PCmer by default, the conv-only conformer with
``use_naive_v2`` -- LayerNorm and the weight-normed output projection).

JAX declares dropout in both decoders (PCmer's residual and attention
dropout of 0.1, the naive encoder's attention dropout of 0.1) but applies
none: PCmer's layers never call a Dropout, and the naive encoder is
conv-only with conv_dropout 0.0. A training forward here is therefore the
inference forward, in ``train()`` as in ``eval()``.

Time-sharded (``parallel/``), JAX unit2control.py:43-64: ``frame_mask``
and ``group`` go to the stack's GroupNorm and PCmer's attention,
``edge_mask`` zeroes the stack's activations outside the utterance before
its second conv and goes to the decoder's conformer convs."""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conformer import ConformerNaiveEncoder
from .nn import Conv1d, Dense, GroupNorm, LayerNorm, WNLinear
from .pcmer import PCmer


def split_to_dict(tensor: torch.Tensor, splits: Mapping[str, int]) -> dict:
    out, start = {}, 0
    for name, size in splits.items():
        out[name] = tensor[..., start:start + size]
        start += size
    return out


def add_speaker(x: torch.Tensor, embed: nn.Embedding, spk_id=None,
                spk_mix_dict: Mapping | None = None) -> torch.Tensor:
    """x + the speaker embedding: of ``spk_id`` (B, 1), 1-based, or with
    ``spk_mix_dict`` {id: weight} the weighted embeddings added one by one
    in the dict's order, as JAX adds them (f32 addition does not commute
    bit for bit)."""
    if spk_mix_dict is None:
        return x + embed(spk_id.long() - 1)
    for k, v in spk_mix_dict.items():
        x = x + v * embed.weight[int(k) - 1]
    return x


class Unit2Control(nn.Module):
    def __init__(self, input_channel: int, n_spk: int,
                 output_splits: Mapping[str, int], use_pitch_aug: bool = False,
                 pcmer_norm: bool = False, use_naive_v2: bool = False,
                 use_conv_stack: bool = True):
        super().__init__()
        self.output_splits = dict(output_splits)
        self.stack_conv0 = Conv1d(input_channel, 256, 3, padding=1)
        self.stack_norm = GroupNorm(4, 256) if use_conv_stack else None
        self.stack_conv1 = (Conv1d(256, 256, 3, padding=1) if use_conv_stack
                            else None)
        self.f0_embed = Dense(1, 256)
        self.phase_embed = Dense(1, 256)
        self.volume_embed = Dense(1, 256)
        self.spk_embed = nn.Embedding(n_spk, 256) if n_spk and n_spk > 1 else None
        # present only in checkpoints trained with pitch augmentation; the
        # loader drops it when the checkpoint has none (io/jax_params.py)
        self.aug_shift_embed = (Dense(1, 256, bias=False) if use_pitch_aug
                                else None)
        self.decoder = (ConformerNaiveEncoder(3, 256) if use_naive_v2
                        else PCmer(3, 8, 256, pcmer_norm=pcmer_norm))
        self.norm = LayerNorm(256)  # eps 1e-5, as JAX
        # weight-normed as in JAX (unit2control.py:119): v and g are trained
        self.dense_out = WNLinear(256, sum(self.output_splits.values()))

    def forward(self, units, f0, phase, volume, spk_id=None, aug_shift=None,
                spk_mix_dict: Mapping | None = None, frame_mask=None,
                group=None, edge_mask=None):
        """units (B, T, n_unit), f0/phase/volume (B, T, 1), spk_id (B, 1)
        1-based or the ``spk_mix_dict`` {id: weight}, aug_shift (B, 1, 1) ->
        (controls dict, hidden (B, T, 256)). ``frame_mask``, ``group`` and
        ``edge_mask``: a time-sharded block's (module docstring)."""
        x = self.stack_conv0(units)
        if self.stack_norm is not None:
            x = F.leaky_relu(self.stack_norm(x, frame_mask, group), 0.01)
            if edge_mask is not None:
                x = x * edge_mask.to(x.dtype)
            x = self.stack_conv1(x)
        x = (x + self.f0_embed(torch.log1p(f0 / 700.0))
             + self.phase_embed(phase / math.pi) + self.volume_embed(volume))
        if self.spk_embed is not None:
            x = add_speaker(x, self.spk_embed, spk_id, spk_mix_dict)
        if self.aug_shift_embed is not None and aug_shift is not None:
            x = x + self.aug_shift_embed(aug_shift / 5.0)
        if isinstance(self.decoder, PCmer):
            x = self.decoder(x, frame_mask, group, edge_mask)
        else:
            x = self.decoder(x, edge_mask)
        x = self.norm(x)
        return split_to_dict(self.dense_out(x), self.output_splits), x
