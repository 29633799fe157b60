"""HuBERT / ContentVec speech encoders and the units encoder (mirrors
ddsp_svc_tpu/features/hubert.py: ``CONV_SPECS``, ``conv_out_frames``,
``FeatureExtractor``, ``PositionalConvEmbedding``, ``TransformerLayer``,
``HubertConfig``, ``HubertModel``, ``ENCODER_CONFIGS``, ``UnitsEncoder``,
with the masked batched forward of zero-padded rows: ``valid_samples``,
``valid_frames``, ``align_index``, ``encode_batched``).

One parameterised model covers the encoder zoo: a 7-layer strided conv
feature extractor (bias-free with a time-global GroupNorm after the first
conv, or biased with a LayerNorm after every conv), the feature projection,
the grouped positional conv, post-LN or pre-LN transformer layers with an
early exit, an optional final projection and the top-k gate. Layout is
(B, T, C); the weights are in the torch layout (io/jax_params.py
``hubert_state_dict`` converts a JAX tree).

Numerics follow flax: attention divides the query by sqrt(head_dim) before
the dot and takes a softmax over f32 logits; GELU is the exact erf form.
flax's LayerNorm computes its variance as E[x^2] - E[x]^2 where torch's
takes two passes, which moves the outputs by ~1e-7 relative per norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..io.jax_params import hubert_state_dict, load_state
from ..models.nn import Conv1d, GroupNorm, random_init_
from ..ops.resample import resample
from ..utils.device import resolve_device

CONV_SPECS = [(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]


def conv_out_frames(n_samples, upto: int = len(CONV_SPECS)):
    """Valid-conv frame count through the extractor stack."""
    t = n_samples
    for k, s in CONV_SPECS[:upto]:
        t = (t - k) // s + 1
    return t


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class FeatureExtractor(nn.Module):
    """7 strided convs, 16 kHz samples (B, L) -> 50 Hz frames (B, T, 512).
    Default mode: bias-free convs and one GroupNorm(512, 512) after conv0
    (statistics over all of time, per channel: the channel norm);
    ``layer_norm_mode`` (HuBERT-Large): biased convs, a LayerNorm over the
    channels after every conv."""

    def __init__(self, layer_norm_mode: bool = False):
        super().__init__()
        self.layer_norm_mode = layer_norm_mode
        self.convs = nn.ModuleList(
            Conv1d(1 if i == 0 else 512, 512, k, stride=s, bias=layer_norm_mode)
            for i, (k, s) in enumerate(CONV_SPECS))
        self.norms = nn.ModuleList(
            [nn.LayerNorm(512, eps=1e-5) for _ in CONV_SPECS] if layer_norm_mode
            else [GroupNorm(512, 512)])

    def forward(self, x: torch.Tensor, valid_in=None) -> torch.Tensor:
        """``valid_in`` (B,): each row's real input length. The convs are
        valid convs, so a frame never reads past its receptive field; only
        the time-global channel norm after conv0 needs statistics masked
        to each row's real frames (JAX ``_ChannelNorm`` with ``valid_t``)."""
        x = x[..., None]
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.layer_norm_mode:
                x = self.norms[i](x)
            elif i == 0:
                x = (self.norms[0](x) if valid_in is None else
                     _masked_channel_norm(x, conv_out_frames(valid_in, 1),
                                          self.norms[0]))
            x = _gelu(x)
        return x


def _masked_channel_norm(x: torch.Tensor, valid_t: torch.Tensor,
                         norm: GroupNorm) -> torch.Tensor:
    """GroupNorm(C, C) over time with each row's statistics taken over its
    first ``valid_t`` frames: x (B, T, C), valid_t (B,)."""
    m = (torch.arange(x.shape[1], device=x.device) < valid_t[:, None])[..., None]
    cnt = valid_t.clamp(min=1).to(x.dtype)[:, None, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mean = torch.where(m, x, zero).sum(dim=1, keepdim=True) / cnt
    var = torch.where(m, (x - mean) ** 2, zero).sum(dim=1, keepdim=True) / cnt
    return (x - mean) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias


class PositionalConvEmbedding(nn.Module):
    """k = 128 conv in 16 groups, padded 64 on both sides, the last output
    step dropped, GELU."""

    def __init__(self, dim: int = 768):
        super().__init__()
        self.conv = Conv1d(dim, dim, 128, padding=64, groups=16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gelu(self.conv(x)[:, :-1, :])


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = out_features =
    dim) on (B, T, dim); ``key_mask`` (B, T) bool: the keys a query may
    attend to (the others get float32's lowest logit, as flax masks)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (
            nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        b, t, dim = x.shape
        h = self.heads
        q, k, v = (proj(x).view(b, t, h, dim // h)
                   for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(dim // h)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, t, dim))


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.attn = SelfAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu(self.fc1(x)))

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        if self.pre_norm:
            x = x + self.attn(self.norm1(x), key_mask)
            return x + self.ffn(self.norm2(x))
        x = self.norm1(x + self.attn(x, key_mask))
        return self.norm2(x + self.ffn(x))


@dataclass(frozen=True)
class HubertConfig:
    dim: int = 768
    heads: int = 12
    ffn_dim: int = 3072
    num_layers: int = 12
    output_layer: int | None = None  # early exit (1-based count of layers run)
    proj_dim: int | None = None  # final projection (256 for hubert-soft)
    pre_norm: bool = False  # True for hubert-large (layer_norm_first)
    extractor_layer_norm: bool = False  # HuBERT-Large conv extractor mode
    pad_center: bool = True  # hubert-soft pads (40, 40) before the convs
    input_normalize: bool = False  # zero-mean / unit-variance waveform
    topk_gate: int | None = None  # CNHubertSoftFish top-k gating

    @property
    def layers_run(self) -> int:
        return self.output_layer or self.num_layers

    @property
    def final_norm(self) -> bool:
        """Whether the model has its ``norm``: before the layers when
        post-LN, after the stack when pre-LN without an early exit."""
        return not self.pre_norm or self.output_layer is None


class HubertModel(nn.Module):
    def __init__(self, config: HubertConfig = HubertConfig()):
        super().__init__()
        cfg = self.config = config
        self.feature_extractor = FeatureExtractor(cfg.extractor_layer_norm)
        self.fp_norm = nn.LayerNorm(512, eps=1e-5)
        self.fp_proj = nn.Linear(512, cfg.dim)
        self.pos_conv = PositionalConvEmbedding(cfg.dim)
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-5) if cfg.final_norm else None
        self.layers = nn.ModuleList(
            TransformerLayer(cfg.dim, cfg.heads, cfg.ffn_dim, cfg.pre_norm)
            for _ in range(cfg.layers_run))
        self.proj = nn.Linear(cfg.dim, cfg.proj_dim) if cfg.proj_dim else None

    def forward(self, audio: torch.Tensor, valid_samples=None) -> torch.Tensor:
        """audio (B, L) at 16 kHz -> units (B, T, dim or proj_dim).

        ``valid_samples`` (B,) int tensor: each row's real sample count, the
        rest zero padding. Every output frame below the row's valid frame
        count then equals the solo forward of the unpadded row: the input
        normalisation, the conv0 channel norm and the attention take their
        statistics and keys from the valid part, and the positional conv
        sees zeros past it (JAX ``HubertModel`` with ``valid_samples``)."""
        cfg = self.config
        zero = torch.zeros((), dtype=audio.dtype, device=audio.device)
        if cfg.input_normalize:
            if valid_samples is None:
                mean = audio.mean(dim=-1, keepdim=True)
                var = audio.var(dim=-1, keepdim=True, unbiased=False)
            else:
                m = (torch.arange(audio.shape[-1], device=audio.device)
                     < valid_samples[:, None])
                cnt = valid_samples.clamp(min=1).to(audio.dtype)[:, None]
                mean = torch.where(m, audio, zero).sum(-1, keepdim=True) / cnt
                var = torch.where(m, (audio - mean) ** 2, zero).sum(
                    -1, keepdim=True) / cnt
            audio = (audio - mean) / torch.sqrt(var + 1e-7)
            if valid_samples is not None:
                audio = torch.where(m, audio, zero)
        valid_in = valid_samples
        if cfg.pad_center:
            audio = F.pad(audio, (40, 40))
            valid_in = None if valid_in is None else valid_in + 80
        x = self.fp_proj(self.fp_norm(self.feature_extractor(audio, valid_in)))
        key_mask = None
        if valid_in is not None:
            key_mask = (torch.arange(x.shape[1], device=x.device)
                        < conv_out_frames(valid_in)[:, None])
            x = torch.where(key_mask[..., None], x, zero)
        x = x + self.pos_conv(x)
        if not cfg.pre_norm:
            x = self.norm(x)
        for layer in self.layers:
            x = layer(x, key_mask)
        if cfg.pre_norm and self.norm is not None:
            x = self.norm(x)
        if self.proj is not None:
            x = self.proj(x)
        if cfg.topk_gate:
            # keep the top-k channels of each frame, renormalised to sum 1
            thresh = torch.topk(x, cfg.topk_gate, dim=-1).values[..., -1:]
            gated = torch.where(x >= thresh, x, torch.zeros_like(x))
            x = gated / gated.sum(dim=-1, keepdim=True)
        return x


# the encoder zoo of the JAX package (the reference's nine and a test-only
# miniature)
ENCODER_CONFIGS: dict[str, HubertConfig] = {
    "hubertsoft": HubertConfig(proj_dim=256),
    "hubertbase": HubertConfig(output_layer=9, proj_dim=256, pad_center=False),
    "hubertbase768": HubertConfig(output_layer=9, pad_center=False),
    "hubertbase768l12": HubertConfig(output_layer=12, pad_center=False),
    "hubertlarge1024l24": HubertConfig(
        dim=1024, heads=16, ffn_dim=4096, num_layers=24, output_layer=24,
        pre_norm=True, extractor_layer_norm=True, pad_center=False),
    "contentvec": HubertConfig(output_layer=9, proj_dim=256, pad_center=False),
    "contentvec768": HubertConfig(output_layer=9, pad_center=False),
    "contentvec768l12": HubertConfig(output_layer=12, pad_center=False),
    "cnhubertsoftfish": HubertConfig(proj_dim=256, pad_center=False,
                                     input_normalize=True, topk_gate=10),
    "tiny": HubertConfig(dim=64, heads=2, ffn_dim=128, num_layers=2,
                         proj_dim=256),
}


class UnitsEncoder:
    """The reference's Units_Encoder on one device (the CUDA card unless
    ``device`` says otherwise). ``params`` is the JAX package's variables
    tree (``{"params": ...}``, as ``utils/params.load_params`` returns it);
    without it the model takes random weights from ``seed``."""

    def __init__(self, encoder: str, params=None,
                 encoder_sample_rate: int = 16000, encoder_hop_size: int = 320,
                 cnhubertsoft_gate: int = 10,
                 device: str | torch.device | None = None, seed: int = 0):
        if encoder not in ENCODER_CONFIGS:
            raise ValueError(f" [x] Unknown units encoder: {encoder}")
        self.device = resolve_device(device)
        cfg = ENCODER_CONFIGS[encoder]
        if cfg.topk_gate is not None:
            # a gate <= 0 turns the gating off
            cfg = replace(cfg, topk_gate=(cnhubertsoft_gate if cnhubertsoft_gate
                                          and cnhubertsoft_gate > 0 else None))
        model = HubertModel(cfg)
        if params is None:
            random_init_(model, torch.Generator().manual_seed(seed))
        else:
            load_state(model, hubert_state_dict(params["params"], cfg))
        self.model = model.to(self.device).eval()
        self.encoder_sample_rate = encoder_sample_rate
        self.encoder_hop_size = encoder_hop_size

    def valid_frames(self, n_samples: int, sample_rate: int) -> int:
        """Encoder frames a solo ``encode`` of ``n_samples`` produces: also
        the count of exact rows of a masked batched forward."""
        n = n_samples
        if sample_rate != self.encoder_sample_rate:
            n = -((-n * self.encoder_sample_rate) // sample_rate)  # ceil
        n = max(n, 400)
        if self.model.config.pad_center:
            n += 80
        return int(conv_out_frames(n))

    def align_index(self, n_samples: int, sample_rate: int,
                    hop_size: int) -> np.ndarray:
        """``encode``'s nearest-index alignment onto the synth hop grid,
        clipped to the request's own valid frame count: what a padded batch
        row gathers with."""
        n_frames = n_samples // hop_size + 1
        ratio = (hop_size / sample_rate) / (
            self.encoder_hop_size / self.encoder_sample_rate)
        return np.clip(np.round(ratio * np.arange(n_frames)).astype(np.int64),
                       0, self.valid_frames(n_samples, sample_rate) - 1)

    @torch.no_grad()
    def encode_batched(self, audio: torch.Tensor, sample_rate: int,
                       valid_samples: torch.Tensor) -> torch.Tensor:
        """Zero-padded rows (B, L) at ``sample_rate`` with ``valid_samples``
        (B,) real samples each -> units (B, T, C) on the ENCODER grid, where
        each row's first ``valid_frames(valid_samples[i], sample_rate)``
        frames equal a solo ``encode`` of the unpadded row (JAX
        ``make_batched_encode_fn``): each row's tail past its valid samples
        (after a resample, past ceil(valid * enc / sr)) is zeroed, rows
        shorter than 400 samples are padded to it, and the model runs
        masked. The zeroing is done at the encoder's own rate too, where
        JAX leaves the tail: a mu-law row's padding decodes to 8.5e-5, not
        0, and the center pad of the encoders that have one would read it.
        Align each row with ``align_index``."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        valid = torch.as_tensor(valid_samples, dtype=torch.int64,
                                device=self.device)
        enc_sr = self.encoder_sample_rate
        if sample_rate != enc_sr:
            audio = resample(audio, sample_rate, enc_sr)
            valid = -((-valid * enc_sr) // sample_rate)  # ceil, as resample
        audio = torch.where(torch.arange(audio.shape[-1], device=self.device)
                            < valid[:, None], audio,
                            torch.zeros((), device=self.device))
        if audio.shape[-1] < 400:
            audio = F.pad(audio, (0, 400 - audio.shape[-1]))
        return self.model(audio, valid_samples=valid.clamp(min=400))

    @torch.no_grad()
    def encode(self, audio, sample_rate: int, hop_size: int) -> torch.Tensor:
        """audio (B, L) at ``sample_rate`` -> units (B, L // hop_size + 1, C)
        on the encoder's device: resampled to the encoder's rate, padded to
        at least 400 samples, encoded, and each synth frame given its
        nearest encoder frame (index rounded half to even on the host)."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        n_frames = audio.shape[-1] // hop_size + 1
        if sample_rate != self.encoder_sample_rate:
            audio = resample(audio, sample_rate, self.encoder_sample_rate)
        if audio.shape[-1] < 400:
            audio = F.pad(audio, (0, 400 - audio.shape[-1]))
        units = self.model(audio)
        ratio = (hop_size / sample_rate) / (
            self.encoder_hop_size / self.encoder_sample_rate)
        index = np.clip(np.round(ratio * np.arange(n_frames)).astype(np.int64),
                        0, units.shape[1] - 1)
        return units[:, torch.from_numpy(index).to(self.device)]
