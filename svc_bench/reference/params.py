"""Every parameter of the served models, by the port's state-dict name:
``spec(cfg)`` -> {group: {name: (shape, init)}} for the units encoder, the
cascade and the vocoder. ``init`` is ("uniform", bound) for the torch
default range U(-1/sqrt(fan_in), 1/sqrt(fan_in)) of a weight and its bias,
("ones",), ("zeros",), or ("norm_of", name) for a weight-normed layer's
gain g = ||v|| per output row. The denoiser's output projection is drawn
like the rest (a serving model's, not a training init's zeros)."""
from __future__ import annotations

import math


def _layer(out: dict, name: str, shape: tuple, bias: bool = True,
           fan_in: int | None = None) -> None:
    bound = 1.0 / math.sqrt(fan_in or math.prod(shape[1:]))
    out[name + ".weight"] = (tuple(shape), ("uniform", bound))
    if bias:
        out[name + ".bias"] = ((shape[0],), ("uniform", bound))


def _norm(out: dict, name: str, width: int) -> None:
    out[name + ".weight"] = ((width,), ("ones",))
    out[name + ".bias"] = ((width,), ("zeros",))


def _conformer(out: dict, p: str, dim: int, inner: int, k: int = 31) -> None:
    _layer(out, f"{p}.conv1", (2 * inner, dim, 1))
    _layer(out, f"{p}.depthwise", (inner, 1, k))
    _layer(out, f"{p}.conv2", (dim, inner, 1))


def encoder_spec(enc: dict) -> dict:
    out: dict = {}
    for i, (k, _) in enumerate(((10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))):
        _layer(out, f"feature_extractor.convs.{i}", (512, 1 if i == 0 else 512, k),
               bias=False)
    _norm(out, "feature_extractor.norms.0", 512)
    _norm(out, "fp_norm", 512)
    dim, ffn = enc["dim"], enc["ffn_dim"]
    _layer(out, "fp_proj", (dim, 512))
    _layer(out, "pos_conv.conv", (dim, dim // 16, 128))
    _norm(out, "norm", dim)
    for i in range(enc["layers"]):
        p = f"layers.{i}"
        for n in ("query", "key", "value", "out"):
            _layer(out, f"{p}.attn.{n}", (dim, dim))
        _norm(out, f"{p}.norm1", dim)
        _norm(out, f"{p}.norm2", dim)
        _layer(out, f"{p}.fc1", (ffn, dim))
        _layer(out, f"{p}.fc2", (dim, ffn))
    if enc.get("proj_dim"):
        _layer(out, "proj", (enc["proj_dim"], dim))
    return out


def model_spec(cfg: dict) -> dict:
    data, m = cfg["data"], cfg["model"]
    out: dict = {}
    p = "ddsp_model.unit2ctrl"
    _layer(out, f"{p}.stack_conv0", (256, data["encoder_out_channels"], 3))
    _norm(out, f"{p}.stack_norm", 256)
    _layer(out, f"{p}.stack_conv1", (256, 256, 3))
    for n in ("f0_embed", "phase_embed", "volume_embed"):
        _layer(out, f"{p}.{n}", (256, 1))
    if m.get("use_pitch_aug"):
        _layer(out, f"{p}.aug_shift_embed", (256, 1), bias=False)
    if int(m.get("n_spk", 1)) > 1:
        raise ValueError("the reference serves one speaker (n_spk 1)")
    for i in range(3):
        _conformer(out, f"{p}.decoder.layers.{i}.conformer", 256, 512)
    _norm(out, f"{p}.norm", 256)
    n_out = 4 * (m["win_length"] // 2 + 1)
    bound = 1.0 / math.sqrt(256)
    out[f"{p}.dense_out.weight_v"] = ((n_out, 256), ("uniform", bound))
    out[f"{p}.dense_out.weight_g"] = ((n_out,), ("norm_of", f"{p}.dense_out.weight_v"))
    out[f"{p}.dense_out.bias"] = ((n_out,), ("uniform", bound))
    q = {"DiffusionFast": "denoise_fn", "RectifiedFlow": "velocity_fn"}[m["type"]]
    mels, dim = cfg["vocoder"]["num_mels"], m["n_chans"]
    _layer(out, f"{q}.input_projection", (dim, mels, 1))
    _layer(out, f"{q}.diff_emb_0", (4 * dim, dim))
    _layer(out, f"{q}.diff_emb_1", (dim, 4 * dim))
    for i in range(m["n_layers"]):
        r = f"{q}.layers.{i}"
        _layer(out, f"{r}.diffusion_step_projection", (dim, dim, 1))
        _layer(out, f"{r}.condition_projection", (dim, mels, 1))
        _conformer(out, f"{r}.conformer", dim, 2 * dim)
    _layer(out, f"{q}.output_projection", (mels, dim, 1))
    return out


def vocoder_spec(voc: dict) -> dict:
    out: dict = {}
    _layer(out, "model.m_source.l_linear", (1, 9))
    c0, mels = voc["upsample_initial_channel"], voc["num_mels"]
    _layer(out, "model.conv_pre", (c0, mels, 7))
    rates, kernels = voc["upsample_rates"], voc["upsample_kernel_sizes"]
    ks, dils = voc["resblock_kernel_sizes"], voc["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(rates, kernels)):
        c_in, c = c0 // 2 ** i, c0 // 2 ** (i + 1)
        # a transposed conv's weight is (in, out, k); torch's fan_in is out k
        _layer(out, f"model.ups.{i}", (c_in, c, k), bias=False, fan_in=c * k)
        out[f"model.ups.{i}.bias"] = ((c,), ("uniform", 1.0 / math.sqrt(c * k)))
    for i in range(len(rates)):
        c = c0 // 2 ** (i + 1)
        s = math.prod(rates[i + 1:])
        _layer(out, f"model.noise_convs.{i}", (c, 1, 2 * s if i + 1 < len(rates) else 1))
    for i in range(len(rates)):
        c = c0 // 2 ** (i + 1)
        for j, (rk, rd) in enumerate(zip(ks, dils)):
            p = f"model.resblocks.{i * len(ks) + j}"
            for n in ("convs1", "convs2"):
                for d in range(len(rd)):
                    _layer(out, f"{p}.{n}.{d}", (c, c, rk))
    _layer(out, "model.conv_post", (1, c0 // 2 ** len(rates), 7))
    return out


def spec(cfg: dict) -> dict:
    return {"encoder": encoder_spec(cfg["encoder"]), "model": model_spec(cfg),
            "vocoder": vocoder_spec(cfg["vocoder"])}
