"""The yardstick's arithmetic: the card's published peaks and the model
work a served request needs, counted from its real (unpadded) frames at
the configuration's widths.

A multiply-add is 2 FLOPs. Counted: every convolution and matrix product
(the encoder's resampler, conv extractor, projections, attention and
feed-forward; the DDSP stage's convs, conformer and output layer; the
denoiser's projections and conformer layers at every sampler call; the
vocoder's convs, transposed convs and ResBlock groups) and the FFTs at 2.5
N log2 N for a real transform of N points. Not counted: elementwise work,
norms, the sampler's updates and the sine source, all a small fraction."""
from __future__ import annotations

import math

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOP_PER_S = 494.7e12
# float32 accuracy on the tensor cores: split TF32, three products each
# (the port's K2 and K3), so a third of the TF32 rate
PEAK_F32_TC_FLOP_PER_S = PEAK_TF32_FLOP_PER_S / 3


def frames(n_samples: int, block: int) -> int:
    return n_samples // block + 1


def fft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def conv_flops(t_out: int, c_in: int, c_out: int, k: int, groups: int = 1) -> float:
    return 2.0 * t_out * (c_in // groups) * c_out * k


def encoder_flops(enc: dict, n_samples: int, sample_rate: int) -> float:
    """The resampler to the encoder's rate, the conv extractor, the
    projection, the positional conv and the transformer layers."""
    n16 = max(-(-n_samples * enc["sample_rate"] // sample_rate), 400)
    g = math.gcd(sample_rate, enc["sample_rate"])
    orig, new = sample_rate // g, enc["sample_rate"] // g
    width = math.ceil(128 * orig / (min(orig, new) * 0.99))
    total = 2.0 * new * (2 * width + orig) * (n_samples // orig + 1)
    if enc.get("pad_center"):
        n16 += 80
    t, c_in = n16, 1
    for i, (k, s) in enumerate(((10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))):
        t = (t - k) // s + 1
        total += conv_flops(t, c_in, 512, k)
        c_in = 512
    dim, ffn = enc["dim"], enc["ffn_dim"]
    # the positional conv gives t + 1 frames, the last dropped
    total += 2.0 * t * 512 * dim + conv_flops(t + 1, dim, dim, 128, groups=16)
    per_layer = 4 * 2.0 * t * dim * dim + 2 * 2.0 * t * t * dim + 2 * 2.0 * t * dim * ffn
    total += enc["layers"] * per_layer
    if enc.get("proj_dim"):
        total += 2.0 * t * dim * enc["proj_dim"]
    return total


def ddsp_flops(cfg: dict, t: int) -> float:
    """CombSubSuperFast: Unit2Control and the STFT filtering (two forward
    transforms and one inverse over T + 1 frames)."""
    n_unit = cfg["data"]["encoder_out_channels"]
    win = cfg["model"]["win_length"]
    total = conv_flops(t, n_unit, 256, 3) + conv_flops(t, 256, 256, 3)
    total += 3 * 2.0 * t * 256  # the f0, phase and volume embeddings
    total += 3 * (conv_flops(t, 256, 1024, 1) + conv_flops(t, 512, 512, 31, groups=512)
                  + conv_flops(t, 512, 256, 1))
    total += 2.0 * t * 256 * 4 * (win // 2 + 1)
    return total + 3 * (t + 1) * fft_flops(win)


def mel_flops(voc: dict, t: int) -> float:
    return t * (fft_flops(voc["n_fft"]) + 2.0 * voc["num_mels"] * (voc["n_fft"] // 2 + 1))


def conformer_layer_flops(dim: int, cond: int, t: int, k: int = 31) -> float:
    """One denoiser layer, K3's work: the condition projection, the GLU
    conv, the depthwise conv and the output conv."""
    inner = 2 * dim
    return 2.0 * t * (cond * dim + dim * 2 * inner + inner * dim) + 2.0 * t * inner * k


def conformer_layer_bytes(dim: int, cond: int, t: int) -> float:
    """K3's activations: x and cond read, the output written (float32)."""
    return 4.0 * t * (2 * dim + cond)


def conformer_weight_bytes(dim: int, cond: int, k: int = 31) -> float:
    inner = 2 * dim
    return 4.0 * (cond * dim + dim + dim * 2 * inner + 2 * inner + inner * k + inner
                  + inner * dim + dim)


def sampler_calls(cfg: dict) -> int:
    m, inf = cfg["model"], cfg["infer"]
    if m["type"] == "DiffusionFast":
        return int(m["k_step_max"]) // int(inf["speedup"])
    if m["type"] == "RectifiedFlow":
        return int(inf["infer_step"]) * (4 if inf.get("method") == "rk4" else 1)
    raise ValueError(f"no sampler count for {m['type']!r}")


def denoiser_flops(cfg: dict, t: int) -> float:
    m, mels = cfg["model"], cfg["vocoder"]["num_mels"]
    dim = m["n_chans"]
    per_call = (2 * 2.0 * t * mels * dim  # input and output projections
                + 2 * 2.0 * dim * 4 * dim  # the step embedding's MLP
                + m["n_layers"] * (2.0 * dim * dim  # each layer's step projection
                                   + conformer_layer_flops(dim, mels, t)))
    return sampler_calls(cfg) * per_call


def resblock_stages(voc: dict, t: int) -> list[tuple[int, int]]:
    """(channels, samples) of each upsampling stage for t mel frames."""
    out, length = [], t
    for i, u in enumerate(voc["upsample_rates"]):
        length *= u
        out.append((voc["upsample_initial_channel"] // 2 ** (i + 1), length))
    return out


def resblock_flops(voc: dict, t: int) -> float:
    """K2's work: every stage's ResBlock1 chains, two convs per dilation."""
    taps = sum(k * len(d) * 2 for k, d in zip(voc["resblock_kernel_sizes"],
                                              voc["resblock_dilation_sizes"]))
    return sum(2.0 * n * c * c * taps for c, n in resblock_stages(voc, t))


def resblock_bytes(voc: dict, t: int) -> float:
    """K2's activations: each stage's input read and output written."""
    return sum(2 * 4.0 * n * c for c, n in resblock_stages(voc, t))


def resblock_weight_bytes(voc: dict) -> float:
    """The weights and biases of every stage's ResBlock groups: what one
    vocoder call's K2 launches read once each."""
    taps = sum(k * len(d) * 2 for k, d in zip(voc["resblock_kernel_sizes"],
                                              voc["resblock_dilation_sizes"]))
    convs = sum(len(d) * 2 for d in voc["resblock_dilation_sizes"])
    return sum(4.0 * (c * c * taps + c * convs) for c, _ in resblock_stages(voc, 1))


def vocoder_flops(voc: dict, t: int) -> float:
    c0, mels = voc["upsample_initial_channel"], voc["num_mels"]
    total = conv_flops(t, mels, c0, 7)
    total += 2.0 * t * math.prod(voc["upsample_rates"]) * 9  # the source's linear
    length = t
    for i, (u, k) in enumerate(zip(voc["upsample_rates"], voc["upsample_kernel_sizes"])):
        c_in, c = c0 // 2 ** i, c0 // 2 ** (i + 1)
        total += 2.0 * length * c_in * c * k  # transposed conv, per input sample
        length *= u
        s = math.prod(voc["upsample_rates"][i + 1:])
        total += conv_flops(length, 1, c, 2 * s if i + 1 < len(voc["upsample_rates"]) else 1)
    total += resblock_flops(voc, t)
    return total + conv_flops(length, c0 // 2 ** len(voc["upsample_rates"]), 1, 7)


def yin_flops(n_samples: int, sample_rate: int, hop: int, f0_min: float,
              f0_max: float) -> float:
    """The device YIN: the decimation filter and three FFTs a frame."""
    factor = 1
    while sample_rate / (factor * 2) >= 16.0 * f0_max and hop % (factor * 2) == 0:
        factor *= 2
    sr_eff = sample_rate / factor
    tau_max = int(sr_eff / f0_min) + 1
    n_fft = 1 << math.ceil(math.log2(4 * tau_max))
    taps = 32 * factor + 1 if factor > 1 else 0
    return (2.0 * taps * (n_samples // factor)
            + frames(n_samples, hop) * 3 * fft_flops(n_fft))


def request_flops(cfg: dict, serve: dict, n_samples: int) -> dict:
    """{stage: FLOPs} of one request of ``n_samples`` input samples."""
    data, voc = cfg["data"], cfg["vocoder"]
    t = frames(n_samples, data["block_size"])
    return {"encoder": encoder_flops(cfg["encoder"], n_samples, data["sampling_rate"]),
            "f0": yin_flops(n_samples, data["sampling_rate"], data["block_size"],
                            serve["f0_min"], serve["f0_max"]),
            "ddsp": ddsp_flops(cfg, t), "mel": mel_flops(voc, t),
            "denoiser": denoiser_flops(cfg, t), "vocoder": vocoder_flops(voc, t)}


def least_seconds(flops: float, n_bytes: float, peak_flops: float) -> float:
    """The least time the card needs: the larger of the two bounds."""
    return max(flops / peak_flops, n_bytes / PEAK_BYTES_PER_S)
