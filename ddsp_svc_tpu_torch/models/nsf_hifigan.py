"""NSF-HiFiGAN (mirrors ddsp_svc_tpu/models/nsf_hifigan.py: ``ResBlock1``,
``ResBlock2``, ``SourceModuleHnNSF``, ``Generator``, and for GAN training
``DiscriminatorP``, ``MultiPeriodDiscriminator``, ``DiscriminatorS``,
``MultiScaleDiscriminator`` and the three losses). A serving generator
holds its weights folded (the loader folds JAX's weight norm once); a
training generator (``weight_norm=True``) holds them as JAX trains them,
(v, g) per conv, folded at every call. With ResBlock1 (``resblock: "1"``)
each upsample stage's resblock mean runs through kernel K2
(ops/cuda_resblock.resblock_group) -- on all five stages, where the TPU
path fused only the stages with C <= 128 -- and each stage's weights are
packed for the kernel once per model (``Generator.stage_weights``). K2
serves ResBlock1 only, as the JAX package's fused path does
(nsf_hifigan.py:201-204): a ResBlock2 generator runs its plain convs.

Called with ``dtype=torch.bfloat16`` (the JAX generator's ``dtype``, nsf_hifigan.py
:128-227) the convs run in bf16 and the activations between them are bf16;
the parameters stay float32 and the sine source f32. The fused stages
follow the JAX dispatch (nsf_hifigan.py:200-221): K2's bf16 class
(``resblock_group_bf16``) where C <= 128 and 128 % C == 0, the stock bf16
ResBlock1 chain elsewhere (the C = 256 stage at the default widths)."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_resblock import LRELU_SLOPE, PackedResblocks, resblock_group
from ..ops.source import sine_gen
from .nn import Conv1d, Conv2d, ConvTranspose1d


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """JAX ``leaky_relu`` (nn.py:396): ``where(x >= 0, x, slope * x)``, with
    the slope taken in x's type (weakly typed in JAX, so rounded to bf16 on a
    bf16 x before the product)."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


class ResBlock1(nn.Module):
    """Parameters of one ResBlock1 chain (``convs1.i`` dilated by the
    chain's i-th dilation, ``convs2.i`` undilated). The chain runs inside
    ``resblock_group``; ``forward`` is the stock chain, which a bf16
    generator runs at the stages K2's bf16 class does not serve."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), weight_norm: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size - 1) * d // 2, weight_norm=weight_norm)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size,
                   padding=(kernel_size - 1) // 2, weight_norm=weight_norm)
            for _ in dilation)

    def forward(self, x, dtype: torch.dtype | None = None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(leaky_relu(x, LRELU_SLOPE), dtype)
            x = c2(leaky_relu(xt, LRELU_SLOPE), dtype) + x
        return x

    def chain_weights(self) -> list:
        """(weight, bias) pairs in chain order convs1_0, convs2_0, ...; a
        weight-normed conv's weight folded from (v, g) at this call."""
        out = []
        for c1, c2 in zip(self.convs1, self.convs2):
            out += [(c1.folded_weight(), c1.bias), (c2.folded_weight(), c2.bias)]
        return out


class ResBlock2(nn.Module):
    """The ResBlock2 chain: one conv per dilation d, x = x +
    conv_d(leaky_relu(x))."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), weight_norm: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size - 1) * d // 2, weight_norm=weight_norm)
            for d in dilation)

    def forward(self, x, dtype: torch.dtype | None = None):
        for conv in self.convs:
            x = conv(leaky_relu(x, LRELU_SLOPE), dtype) + x
        return x


class SourceModuleHnNSF(nn.Module):
    """Sine bank -> Linear(h + 1, 1) -> tanh merged excitation."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 8,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.sampling_rate, self.harmonic_num = sampling_rate, harmonic_num
        self.sine_amp, self.add_noise_std = sine_amp, add_noise_std
        self.voiced_threshold = voiced_threshold
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0, upp: int, sine_kwargs=None,
                generator: torch.Generator | None = None):
        sines = sine_gen(f0, upp, self.sampling_rate, self.harmonic_num,
                         sine_amp=self.sine_amp, noise_std=self.add_noise_std,
                         voiced_threshold=self.voiced_threshold,
                         generator=generator, **(sine_kwargs or {}))
        return torch.tanh(self.l_linear(sines))  # (B, T * upp, 1)


class Generator(nn.Module):
    """mel (B, T, M), f0 (B, T) -> audio (B, T * upp). ``weight_norm``: the
    convs that JAX weight-norms (all but the noise convs and the source's
    linear) hold (v, g) and fold at every call, as in training."""

    def __init__(self, sampling_rate: int, num_mels: int = 128,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4),
                 upsample_initial_channel: int = 512, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 weight_norm: bool = False):
        super().__init__()
        self.weight_norm = weight_norm
        if str(resblock) not in ("1", "2"):
            raise ValueError(f"resblock {resblock!r}: '1' or '2'")
        self.resblock = str(resblock)
        n_up = len(upsample_rates)
        if upsample_initial_channel < 2 ** n_up:
            raise ValueError("upsample_initial_channel too small: channels "
                             "halve per stage")
        self.upsample_rates = tuple(upsample_rates)
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.upp = int(math.prod(upsample_rates))
        self.m_source = SourceModuleHnNSF(sampling_rate, harmonic_num=8)
        c0 = upsample_initial_channel
        self.conv_pre = Conv1d(num_mels, c0, 7, padding=3,
                               weight_norm=weight_norm)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_in, c_cur = c0 // 2 ** i, c0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(c_in, c_cur, k, stride=u,
                                            padding=(k - u) // 2,
                                            weight_norm=weight_norm))
            if i + 1 < n_up:
                s = int(math.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(
                    Conv1d(1, c_cur, 2 * s, stride=s, padding=s // 2))
            else:
                self.noise_convs.append(Conv1d(1, c_cur, 1))
            block = ResBlock1 if self.resblock == "1" else ResBlock2
            for rk, rd in zip(self.kernel_sizes, self.dilations):
                self.resblocks.append(block(c_cur, rk, rd, weight_norm))
        self.conv_post = Conv1d(c0 // 2 ** n_up, 1, 7, padding=3,
                                weight_norm=weight_norm)
        self._packed = {}  # stage -> (weights' identity, PackedResblocks)

    def stage_weights(self, i: int) -> PackedResblocks:
        """Stage ``i``'s resblock weights packed for K2, made once per model
        and made again only when a weight or bias is replaced or changed in
        place (another tensor, device or version). A weight-normed
        generator folds its weights anew at every call, so it packs them
        at every call, and keeps no pack (nor its autograd graph)."""
        n_k = len(self.kernel_sizes)
        rbw = [blk.chain_weights() for blk in self.resblocks[i * n_k:(i + 1) * n_k]]
        if self.weight_norm:
            return PackedResblocks(rbw)
        key = tuple((t.data_ptr(), t.device, t._version)
                    for pairs in rbw for pair in pairs for t in pair)
        cached = self._packed.get(i)
        if cached is None or cached[0] != key:
            cached = (key, PackedResblocks(rbw))
            self._packed[i] = cached
        return cached[1]

    def forward(self, mel, f0, sine_kwargs=None,
                generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None):
        """``sine_kwargs``: optional ``rand_ini`` (1, 1, 9) and ``noise``
        (B, T * upp, 9) for the sine source; drawn from ``generator``
        otherwise. ``dtype`` (default float32): the type the convs and
        activations run in; the audio comes back in it."""
        dtype = dtype or torch.float32
        har_source = self.m_source(f0, self.upp, sine_kwargs, generator)
        x = self.conv_pre(mel, dtype)
        n_k = len(self.kernel_sizes)
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(leaky_relu(x, LRELU_SLOPE), dtype)
            x = (x + noise_conv(har_source, dtype)).contiguous()
            c = x.shape[-1]
            fused = self.resblock == "1" and (
                dtype == torch.float32 or (c <= 128 and 128 % c == 0))
            if fused:
                x = resblock_group(x, self.stage_weights(i), self.kernel_sizes,
                                   self.dilations)
            else:
                blocks = self.resblocks[i * n_k:(i + 1) * n_k]
                x = sum(blk(x, dtype) for blk in blocks) / n_k
        x = self.conv_post(leaky_relu(x, 0.01), dtype)
        return torch.tanh(x)[..., 0]


# ---------------------------------------------------------------------------
# GAN training: the discriminators and losses (nsf_hifigan.py:237-376)
# ---------------------------------------------------------------------------


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class DiscriminatorP(nn.Module):
    """x (B, L) -> (score (B, n), feature maps): reflect-padded to a
    multiple of the period, viewed (B, L / p, p, 1) (NHWC) and run through
    weight-normed (or spectral-normed) 2-D convs with k x 1 kernels."""

    CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        wn, sn = not use_spectral_norm, use_spectral_norm
        pad = ((get_padding(5, 1),) * 2, (0, 0))
        c_in, convs = 1, []
        for c in self.CHANNELS:
            convs.append(Conv2d(c_in, c, (kernel_size, 1), (stride, 1), pad,
                                weight_norm=wn, spectral_norm=sn))
            c_in = c
        convs.append(Conv2d(c_in, 1024, (kernel_size, 1), (1, 1),
                            ((2, 2), (0, 0)), weight_norm=wn, spectral_norm=sn))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), ((1, 1), (0, 0)),
                                weight_norm=wn, spectral_norm=sn)

    def forward(self, x: torch.Tensor):
        fmap = []
        b, t = x.shape
        if t % self.period:
            x = F.pad(x[:, None], (0, self.period - t % self.period),
                      mode="reflect")[:, 0]
            t = x.shape[-1]
        x = x.reshape(b, t // self.period, self.period, 1)
        for conv in self.convs:
            x = leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)

    def forward(self, y, y_hat):
        return _both(self.discriminators, [y] * len(self.discriminators),
                     [y_hat] * len(self.discriminators))


def _both(discs, ys, y_hats):
    rs, gs, fr, fg = [], [], [], []
    for d, y, y_hat in zip(discs, ys, y_hats):
        r, fmap_r = d(y)
        g, fmap_g = d(y_hat)
        rs.append(r)
        gs.append(g)
        fr.append(fmap_r)
        fg.append(fmap_g)
    return rs, gs, fr, fg


class DiscriminatorS(nn.Module):
    """x (B, L) -> (score, feature maps): grouped, strided 1-D convs,
    weight-normed (spectral-normed on the MSD's first scale)."""

    SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
             (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
             (1024, 5, 1, 1, 2))

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        wn, sn = not use_spectral_norm, use_spectral_norm
        c_in, convs = 1, []
        for c, k, st, g, p in self.SPECS:
            convs.append(Conv1d(c_in, c, k, stride=st, padding=p, groups=g,
                                weight_norm=wn, spectral_norm=sn))
            c_in = c
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv1d(c_in, 1, 3, padding=1, weight_norm=wn,
                                spectral_norm=sn)

    def forward(self, x: torch.Tensor):
        fmap = []
        x = x[..., None]
        for conv in self.convs:
            x = leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def avg_pool_4_2(v: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(4, 2, padding=2) as JAX writes it: zero-padded by 2 on each
    side, window sums of 4 at stride 2, divided by 4."""
    vp = F.pad(v, (2, 2))
    return F.avg_pool1d(vp[:, None], 4, 2)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0)) for i in range(scales))

    def forward(self, y, y_hat):
        ys, y_hats = [], []
        for i in range(len(self.discriminators)):
            if i:
                y, y_hat = avg_pool_4_2(y), avg_pool_4_2(y_hat)
            ys.append(y)
            y_hats.append(y_hat)
        return _both(self.discriminators, ys, y_hats)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_loss(disc_outputs) -> torch.Tensor:
    loss = 0.0
    for dg in disc_outputs:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss
