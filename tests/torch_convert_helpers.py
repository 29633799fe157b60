"""Synthetic upstream DDSP-SVC checkpoints drawn from a seed (no JAX): the
upstream torch layouts the converters read, with the key lists of
tests/test_convert.py and tests/test_convert_legacy.py, at any width.
``tests/test_torch_convert.py`` draws them small; ``chip_smoke.py`` phase
24 at the published widths.

Values are drawn so that a forward stays in range at full width: kernels
U(+-1/sqrt(fan_in)), weight-norm gains U(0.5, 1.5), biases U(+-0.1), norm
scales 1 + U(+-0.1), embeddings N(0, 0.5), FAVOR+ projections N(0, 1),
running variances U(0.5, 1.5). Each function also adds some of the tensors
an upstream file carries that no converter reads (a diffusion's schedule,
a batch norm's step count, fairseq's mask embedding), which must be
dropped."""
from __future__ import annotations

import math

import numpy as np
import torch

PCMER_FEATURES = int(64 * math.log(64))  # FAVOR+ features of a 64-wide head


class Drawer:
    """Fills an upstream state dict: ``put(name, shape)`` draws by the
    name's last part (see the module docstring)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sd: dict[str, np.ndarray] = {}

    def put(self, name: str, shape) -> None:
        rng, last = self.rng, name.rsplit(".", 1)[-1]
        shape = tuple(shape)
        if last in ("weight_g", "original0", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif last == "projection_matrix":
            v = rng.standard_normal(shape)
        elif last in ("bias", "running_mean") or last.startswith("bias_"):
            v = rng.uniform(-0.1, 0.1, shape)
        elif "spk_embed" in name or last == "mask_emb":
            v = rng.standard_normal(shape) * 0.5
        elif len(shape) == 1:  # a norm's scale
            v = 1.0 + rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.uniform(-1, 1, shape) / np.sqrt(int(np.prod(shape[1:])))
        self.sd[name] = np.asarray(v, np.float32)

    def layer(self, name: str, shape, bias: bool = True) -> None:
        """A Linear or conv: ``weight`` of ``shape`` and a bias."""
        self.put(name + ".weight", shape)
        if bias:
            self.put(name + ".bias", shape[:1])

    def wn(self, name: str, shape) -> None:
        """A weight-normed Linear or conv (out first): ``weight_g`` per
        output (torch keeps the other dims as 1), ``weight_v``, a bias."""
        self.put(name + ".weight_g", (shape[0],) + (1,) * (len(shape) - 1))
        self.put(name + ".weight_v", shape)
        self.put(name + ".bias", shape[:1])

    def norm(self, name: str, width: int) -> None:
        self.put(name + ".weight", (width,))
        self.put(name + ".bias", (width,))

    def batch_norm(self, name: str, width: int) -> None:
        self.norm(name, width)
        self.put(name + ".running_mean", (width,))
        self.put(name + ".running_var", (width,))
        self.sd[name + ".num_batches_tracked"] = np.asarray(7, np.int64)


def unit2control(d: Drawer, pre: str, n_unit: int, n_out: int, pcmer: bool,
                 n_spk: int = 1, use_pitch_aug: bool = False) -> None:
    """ddsp/unit2control.py: the conv stack, embeddings, decoder (naive
    conformer or PCmer), norm, weight-normed dense_out."""
    d.layer(pre + "stack.0", (256, n_unit, 3))
    d.norm(pre + "stack.1", 256)
    d.layer(pre + "stack.3", (256, 256, 3))
    for emb in ("f0_embed", "phase_embed", "volume_embed"):
        d.layer(pre + emb, (256, 1))
    if n_spk > 1:
        d.put(pre + "spk_embed.weight", (n_spk, 256))
    if use_pitch_aug:
        d.layer(pre + "aug_shift_embed", (256, 1), bias=False)
    for i in range(3):
        if pcmer:
            lp = pre + f"decoder._layers.{i}."
            for proj in ("to_q", "to_k", "to_v"):
                d.layer(lp + "attn." + proj, (512, 256))
            d.layer(lp + "attn.to_out", (256, 512))
            d.put(lp + "attn.fast_attention.projection_matrix", (PCMER_FEATURES, 64))
            d.norm(lp + "norm", 256)
            d.norm(lp + "conformer.net.0", 256)
            cp, depthwise = lp + "conformer.net.", "4.conv"
        else:
            cp, depthwise = pre + f"decoder.encoder_layers.{i}.conformer.net.", "4"
        d.layer(cp + "2", (1024, 256, 1))
        d.layer(cp + depthwise, (512, 1, 31))
        d.layer(cp + "6", (256, 512, 1))
    d.norm(pre + "norm", 256)
    d.wn(pre + "dense_out", (n_out, 256))


def naive_v2_diff(d: Drawer, pre: str, n_layers: int, n_chans: int,
                  n_mels: int = 128) -> None:
    """diffusion/naive_v2_diff.py (use_mlp=False)."""
    c = n_chans
    d.layer(pre + "input_projection", (c, n_mels, 1))
    d.layer(pre + "diffusion_embedding.1", (4 * c, c))
    d.layer(pre + "diffusion_embedding.3", (c, 4 * c))
    for i in range(n_layers):
        lp = pre + f"residual_layers.{i}."
        d.layer(lp + "diffusion_step_projection", (c, c, 1))
        d.layer(lp + "condition_projection", (c, n_mels, 1))
        d.layer(lp + "conformer.net.2", (4 * c, c, 1))
        d.layer(lp + "conformer.net.4", (2 * c, 1, 31))
        d.layer(lp + "conformer.net.6", (c, 2 * c, 1))
    d.layer(pre + "output_projection", (n_mels, c, 1))


def wavenet(d: Drawer, pre: str, n_layers: int, n_chans: int, n_hidden: int,
            out_dims: int = 128) -> None:
    """diffusion/wavenet.py."""
    c = n_chans
    d.layer(pre + "input_projection", (c, out_dims, 1))
    d.layer(pre + "mlp.0", (4 * c, c))
    d.layer(pre + "mlp.2", (c, 4 * c))
    for i in range(n_layers):
        lp = pre + f"residual_layers.{i}."
        d.layer(lp + "dilated_conv", (2 * c, c, 3))
        d.layer(lp + "diffusion_projection", (c, c))
        d.layer(lp + "conditioner_projection", (2 * c, n_hidden, 1))
        d.layer(lp + "output_projection", (2 * c, c, 1))
    d.layer(pre + "skip_projection", (c, c, 1))
    d.layer(pre + "output_projection", (out_dims, c, 1))


def _schedule(d: Drawer, pre: str, k_step_max: int) -> None:
    """A GaussianDiffusion's registered buffers (read by no converter)."""
    betas = np.linspace(1e-4, 0.02, k_step_max, dtype=np.float32)
    d.sd[pre + "betas"] = betas
    d.sd[pre + "alphas_cumprod"] = np.cumprod(1.0 - betas).astype(np.float32)


def model_state_dict(args, seed: int) -> dict:
    """An upstream ``model_<step>.pt`` state dict of any type the converter
    takes, for a config (DotDict: ``data`` and ``model`` sections)."""
    m, data = args.model, args.data
    d = Drawer(seed)
    n_unit, n_spk = data.encoder_out_channels, m.n_spk or 1
    aug = bool(m.use_pitch_aug)
    cssf_out = 4 * ((m.win_length or 2048) // 2 + 1)
    csf_out = 3 * (data.block_size + 1)
    out_dims = m.out_dims or 128
    if m.type == "Sins":
        unit2control(d, "unit2ctrl.", n_unit,
                     m.n_harmonics + m.n_mag_allpass + m.n_mag_noise, True, n_spk)
    elif m.type == "CombSub":
        unit2control(d, "unit2ctrl.", n_unit,
                     m.n_mag_allpass + m.n_mag_harmonic + m.n_mag_noise, True, n_spk)
    elif m.type == "CombSubFast":
        unit2control(d, "unit2ctrl.", n_unit, csf_out, True, n_spk)
    elif m.type == "CombSubSuperFast":
        unit2control(d, "unit2ctrl.", n_unit, cssf_out, False, n_spk)
    elif m.type == "Diffusion":
        hidden = m.n_hidden or 256
        d.layer("unit_embed", (hidden, n_unit))
        d.layer("f0_embed", (hidden, 1))
        d.layer("volume_embed", (hidden, 1))
        if n_spk > 1:
            d.put("spk_embed.weight", (n_spk, hidden))
        if aug:
            d.layer("aug_shift_embed", (hidden, 1), bias=False)
        wavenet(d, "decoder.denoise_fn.", m.n_layers, m.n_chans, hidden, out_dims)
        _schedule(d, "decoder.", m.k_step_max or 1000)
    elif m.type == "DiffusionNew":
        unit2control(d, "ddsp_model.unit2ctrl.", n_unit, csf_out, True, n_spk, aug)
        wavenet(d, "diff_model.denoise_fn.", m.n_layers, m.n_chans, 256, out_dims)
        _schedule(d, "diff_model.", m.k_step_max or 1000)
    elif m.type in ("DiffusionFast", "RectifiedFlow"):
        unit2control(d, "ddsp_model.unit2ctrl.", n_unit, cssf_out, False, n_spk, aug)
        net = ("diff_model.denoise_fn." if m.type == "DiffusionFast"
               else "reflow_model.velocity_fn.")
        naive_v2_diff(d, net, m.n_layers, m.n_chans, out_dims)
        if m.type == "DiffusionFast":
            _schedule(d, "diff_model.", m.k_step_max or 1000)
    else:
        raise ValueError(f"no upstream layout for {m.type!r}")
    return d.sd


def nsf_hifigan_state_dict(config: dict, seed: int) -> dict:
    """nsf_hifigan/models.py Generator for a config.json dict."""
    d = Drawer(seed)
    rates, kernels = config["upsample_rates"], config["upsample_kernel_sizes"]
    ch = config["upsample_initial_channel"]
    d.wn("conv_pre", (ch, config["num_mels"], 7))
    resblock1 = str(config.get("resblock", "1")) == "1"
    n_k = len(config["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(rates, kernels)):
        c_out = ch // (2 ** (i + 1))
        d.put(f"ups.{i}.weight_g", (ch // (2 ** i), 1, 1))
        d.put(f"ups.{i}.weight_v", (ch // (2 ** i), c_out, k))
        d.put(f"ups.{i}.bias", (c_out,))
        k_noise = 2 * int(np.prod(rates[i + 1:])) if i + 1 < len(rates) else 1
        d.layer(f"noise_convs.{i}", (c_out, 1, k_noise))
        for j, (rk, dil) in enumerate(zip(config["resblock_kernel_sizes"],
                                          config["resblock_dilation_sizes"])):
            pre = f"resblocks.{i * n_k + j}."
            for n in range(len(dil)):
                for conv in (("convs1", "convs2") if resblock1 else ("convs",)):
                    d.wn(f"{pre}{conv}.{n}", (c_out, c_out, rk))
    d.wn("conv_post", (1, ch // (2 ** len(rates)), 7))
    d.layer("m_source.l_linear", (1, 9))
    return d.sd


def hubert_state_dict(layout: str, dim: int, ffn: int, n_layers: int, seed: int,
                      proj_dim: int | None = None, ln_mode: bool = False,
                      parametrized: bool = False) -> dict:
    """A HuBERT / ContentVec checkpoint in the 'bshall', 'fairseq' or 'hf'
    layout (``parametrized``: the HF positional conv's torch >= 2.1 weight
    norm; ``ln_mode``: fairseq's 'layer_norm' extractor)."""
    d = Drawer(seed)
    conv_shapes = [(512, 1, 10)] + [(512, 512, 3)] * 4 + [(512, 512, 2)] * 2
    fe = "feature_extractor."
    for i, s in enumerate(conv_shapes):
        if layout == "bshall":
            d.put(f"{fe}conv{i}.weight", s)
        elif layout == "hf":
            d.put(f"{fe}conv_layers.{i}.conv.weight", s)
        else:
            d.layer(f"{fe}conv_layers.{i}.0", s, bias=ln_mode)
            if ln_mode:
                d.norm(f"{fe}conv_layers.{i}.2.1", 512)
    if not ln_mode:
        d.norm({"bshall": f"{fe}norm0", "fairseq": f"{fe}conv_layers.0.2",
                "hf": f"{fe}conv_layers.0.layer_norm"}[layout], 512)
    fp_norm, fp_proj, pos, norm = {
        "bshall": ("feature_projection.norm", "feature_projection.projection",
                   "positional_embedding.conv", "norm"),
        "fairseq": ("layer_norm", "post_extract_proj", "encoder.pos_conv.0",
                    "encoder.layer_norm"),
        "hf": ("feature_projection.layer_norm", "feature_projection.projection",
               "encoder.pos_conv_embed.conv", "encoder.layer_norm"),
    }[layout]
    d.norm(fp_norm, 512)
    d.layer(fp_proj, (dim, 512))
    if parametrized:
        d.put(pos + ".parametrizations.weight.original0", (1, 1, 128))
        d.put(pos + ".parametrizations.weight.original1", (dim, dim // 16, 128))
    else:
        d.put(pos + ".weight_g", (1, 1, 128))
        d.put(pos + ".weight_v", (dim, dim // 16, 128))
    d.put(pos + ".bias", (dim,))
    d.norm(norm, dim)
    for i in range(n_layers):
        pre = f"encoder.layers.{i}."
        if layout == "bshall":
            d.put(pre + "self_attn.in_proj_weight", (3 * dim, dim))
            d.put(pre + "self_attn.in_proj_bias", (3 * dim,))
            d.layer(pre + "self_attn.out_proj", (dim, dim))
            d.layer(pre + "linear1", (ffn, dim))
            d.layer(pre + "linear2", (dim, ffn))
            d.norm(pre + "norm1", dim)
            d.norm(pre + "norm2", dim)
            continue
        attn = pre + ("attention." if layout == "hf" else "self_attn.")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            d.layer(attn + p, (dim, dim))
        if layout == "hf":
            d.layer(pre + "feed_forward.intermediate_dense", (ffn, dim))
            d.layer(pre + "feed_forward.output_dense", (dim, ffn))
            d.norm(pre + "layer_norm", dim)
        else:
            d.layer(pre + "fc1", (ffn, dim))
            d.layer(pre + "fc2", (dim, ffn))
            d.norm(pre + "self_attn_layer_norm", dim)
        d.norm(pre + "final_layer_norm", dim)
    if proj_dim:
        d.layer({"bshall": "proj", "fairseq": "final_proj", "hf": "proj.1"}[layout],
                (proj_dim, dim))
    if layout == "fairseq":
        d.put("mask_emb", (dim,))
    if layout == "hf":
        d.sd = {"model." + k: v for k, v in d.sd.items()}
    return d.sd


def _conv_block_res(d: Drawer, pre: str, cin: int, cout: int) -> None:
    d.put(pre + ".conv.0.weight", (cout, cin, 3, 3))
    d.batch_norm(pre + ".conv.1", cout)
    d.put(pre + ".conv.3.weight", (cout, cout, 3, 3))
    d.batch_norm(pre + ".conv.4", cout)
    if cin != cout:
        d.layer(pre + ".shortcut", (cout, cin, 1, 1))


def rmvpe_state_dict(seed: int) -> dict:
    """encoder/rmvpe E2E0(4, 1, (2, 2)), as tests/test_convert.py draws it."""
    d = Drawer(seed)
    d.batch_norm("unet.encoder.bn", 1)
    cin = 1
    for i, cout in enumerate((16, 32, 64, 128, 256)):
        for j in range(4):
            _conv_block_res(d, f"unet.encoder.layers.{i}.conv.{j}",
                            cin if j == 0 else cout, cout)
        cin = cout
    for i in range(4):
        cin_i, cout_i = (256, 512) if i == 0 else (512, 512)
        for j in range(4):
            _conv_block_res(d, f"unet.intermediate.layers.{i}.conv.{j}",
                            cin_i if j == 0 else cout_i, cout_i)
    cin = 512
    for i, cout in enumerate((256, 128, 64, 32, 16)):
        d.put(f"unet.decoder.layers.{i}.conv1.0.weight", (cin, cout, 3, 3))
        d.batch_norm(f"unet.decoder.layers.{i}.conv1.1", cout)
        for j in range(4):
            _conv_block_res(d, f"unet.decoder.layers.{i}.conv2.{j}",
                            cout * 2 if j == 0 else cout, cout)
        cin = cout
    d.layer("cnn", (3, 16, 3, 3))
    for suffix in ("", "_reverse"):
        d.put(f"fc.0.gru.weight_ih_l0{suffix}", (768, 384))
        d.put(f"fc.0.gru.weight_hh_l0{suffix}", (768, 256))
        d.put(f"fc.0.gru.bias_ih_l0{suffix}", (768,))
        d.put(f"fc.0.gru.bias_hh_l0{suffix}", (768,))
    d.layer("fc.1", (360, 512))
    return d.sd


def crepe_state_dict(seed: int) -> dict:
    """torchcrepe 'full'."""
    d = Drawer(seed)
    chans = (1, 1024, 128, 128, 128, 256, 512)
    for i in range(1, 7):
        d.layer(f"conv{i}", (chans[i], chans[i - 1], 512 if i == 1 else 64, 1))
        d.batch_norm(f"conv{i}_BN", chans[i])
    d.layer("classifier", (360, 2048))
    return d.sd


def fcpe_state_dict(seed: int, n_layers: int = 6, hidden: int = 512,
                    n_mels: int = 128, out_dims: int = 360) -> dict:
    """torchfcpe CFNaiveMelPE, with its two buffers."""
    d = Drawer(seed)
    d.layer("input_stack.0", (hidden, n_mels, 3))
    d.norm("input_stack.1", hidden)
    d.layer("input_stack.3", (hidden, hidden, 3))
    for i in range(n_layers):
        cp = f"net.encoder_layers.{i}.conformer.net."
        d.layer(cp + "2", (4 * hidden, hidden, 1))
        d.layer(cp + "4", (2 * hidden, 1, 31))
        d.layer(cp + "6", (hidden, 2 * hidden, 1))
    d.norm("norm", hidden)
    d.wn("output_proj", (out_dims, hidden))
    d.sd["cent_table"] = np.linspace(0, 1, out_dims, dtype=np.float32)
    d.sd["gaussian_blurred_cent_mask"] = np.ones((1, out_dims), np.float32)
    return d.sd


def save_upstream(path, sd: dict, wrapper: str | None = "model") -> None:
    """``torch.save`` a state dict as upstream does: under ``wrapper``
    (``model``, ``generator``, ``state_dict``) or bare."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({wrapper: tensors} if wrapper else tensors, str(path))
