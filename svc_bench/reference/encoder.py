"""The units encoder: HuBERT / ContentVec (a 7-layer strided conv feature
extractor with a time-global channel norm after the first conv, the
feature projection, the grouped positional conv, post-LN transformer
layers), run on one request alone, its frames gathered onto the synth's
hop grid."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .layers import conv, gelu, group_norm, layer_norm, linear, resample

CONV_SPECS = ((10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))


def hubert(w: dict, enc: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, L) at the encoder's rate -> units (B, T, dim or proj_dim)."""
    if enc["pad_center"]:
        audio = F.pad(audio, (40, 40))
    x = audio[..., None]
    for i, (k, s) in enumerate(CONV_SPECS):
        x = conv(w, f"feature_extractor.convs.{i}", x, stride=s)
        if i == 0:
            x = group_norm(w, "feature_extractor.norms.0", x, x.shape[-1])
        x = gelu(x)
    x = linear(w, "fp_proj", layer_norm(w, "fp_norm", x))
    x = x + gelu(conv(w, "pos_conv.conv", x, padding=64, groups=16)[:, :-1, :])
    x = layer_norm(w, "norm", x)
    dim, heads = enc["dim"], enc["heads"]
    for i in range(enc["layers"]):
        p = f"layers.{i}"
        b, t, _ = x.shape
        q, k, v = (linear(w, f"{p}.attn.{n}", x).view(b, t, heads, dim // heads)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(dim // heads)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        a = linear(w, f"{p}.attn.out",
                   torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, t, dim))
        x = layer_norm(w, f"{p}.norm1", x + a)
        ffn = linear(w, f"{p}.fc2", gelu(linear(w, f"{p}.fc1", x)))
        x = layer_norm(w, f"{p}.norm2", x + ffn)
    if enc.get("proj_dim"):
        x = linear(w, "proj", x)
    return x


def units(w: dict, enc: dict, audio: torch.Tensor, sample_rate: int,
          hop_size: int) -> torch.Tensor:
    """audio (L,) at ``sample_rate`` -> units (1, L // hop + 1, C): resampled
    to the encoder's rate, padded to 400 samples at least, encoded, and each
    synth frame given its nearest encoder frame (half to even)."""
    n_frames = audio.shape[-1] // hop_size + 1
    x = resample(audio[None], sample_rate, enc["sample_rate"])
    if x.shape[-1] < 400:
        x = F.pad(x, (0, 400 - x.shape[-1]))
    out = hubert(w, enc, x)
    ratio = (hop_size / sample_rate) / (enc["hop_size"] / enc["sample_rate"])
    index = np.clip(np.round(ratio * np.arange(n_frames)).astype(np.int64),
                    0, out.shape[1] - 1)
    return out[:, torch.from_numpy(index).to(out.device)]
