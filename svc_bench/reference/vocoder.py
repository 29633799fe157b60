"""NSF-HiFiGAN: the harmonic sine source merged by a linear layer, the
transposed-conv upsampling stages with the source added through the noise
convs, each stage's mean of its ResBlock1 chains, the output conv."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import carry_cycles, conv, exact_div, linear, quantise

LRELU_SLOPE = 0.1


def sine_source(f0: torch.Tensor, upp: int, sr: int, harmonics: int,
                rand_ini: torch.Tensor, noise: torch.Tensor,
                sine_amp: float = 0.1, noise_std: float = 0.003) -> torch.Tensor:
    """f0 (B, T) -> (B, T upp, harmonics + 1): sines of each harmonic, the
    frames' phases carried as integers of 2^-22 cycles, plus noise."""
    b, t = f0.shape
    dim = harmonics + 1
    f0 = f0[..., None]
    pos = torch.arange(1, upp + 1, dtype=f0.dtype, device=f0.device)
    rad = exact_div(f0, sr) * pos
    rad = rad + carry_cycles(quantise(exact_div(f0, sr) * upp))
    rad = rad.reshape(b, t * upp, 1) * torch.arange(
        1, dim + 1, dtype=f0.dtype, device=f0.device).reshape(1, 1, dim)
    sines = torch.sin(2.0 * math.pi * (rad + rand_ini)) * sine_amp
    uv = torch.repeat_interleave((f0 > 0.0).to(f0.dtype), upp, dim=1)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    return sines * uv + noise_amp * noise


def resblock_chain(w: dict, p: str, x: torch.Tensor, k: int, dilations) -> torch.Tensor:
    for i, d in enumerate(dilations):
        t = conv(w, f"{p}.convs1.{i}", F.leaky_relu(x, LRELU_SLOPE),
                 padding=(k - 1) * d // 2, dilation=d)
        x = conv(w, f"{p}.convs2.{i}", F.leaky_relu(t, LRELU_SLOPE),
                 padding=(k - 1) // 2) + x
    return x


def nsf_hifigan(w: dict, voc: dict, mel: torch.Tensor, f0: torch.Tensor,
                rand_ini: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """mel (B, T, M), f0 (B, T) -> audio (B, T upp)."""
    rates, kernels = voc["upsample_rates"], voc["upsample_kernel_sizes"]
    upp = math.prod(rates)
    src = sine_source(f0, upp, voc["sampling_rate"], 8, rand_ini, noise)
    src = torch.tanh(linear(w, "model.m_source.l_linear", src))
    x = conv(w, "model.conv_pre", mel, padding=3)
    ks, dils = voc["resblock_kernel_sizes"], voc["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(rates, kernels)):
        y = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2),
                               w[f"model.ups.{i}.weight"], w[f"model.ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        x = y.transpose(1, 2)
        s = math.prod(rates[i + 1:])
        x = x + conv(w, f"model.noise_convs.{i}", src,
                     stride=s if s > 1 else 1, padding=s // 2 if s > 1 else 0)
        x = sum(resblock_chain(w, f"model.resblocks.{i * len(ks) + j}", x, rk, rd)
                for j, (rk, rd) in enumerate(zip(ks, dils))) / len(ks)
    x = conv(w, "model.conv_post", F.leaky_relu(x, 0.01), padding=3)
    return torch.tanh(x)[..., 0]
