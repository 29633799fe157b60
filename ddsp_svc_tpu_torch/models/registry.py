"""Model construction from the reference YAML schema (mirrors
ddsp_svc_tpu/models/registry.py ``build_model``/``load_model`` for every
``model.type``: the DDSP family -- Sins, CombSub, CombSubFast,
CombSubSuperFast -- and the cascades Diffusion, DiffusionNew, DiffusionFast
and RectifiedFlow; and ddsp_svc_tpu/train/solver.py ``model_family``)."""
from __future__ import annotations

import os

import torch

from ..utils.device import resolve_device
from .cascade import ReflowUnit2Wav, Unit2Mel, Unit2Wav, Unit2WavFast
from .ddsp import CombSub, CombSubFast, CombSubSuperFast, Sins
from .nn import set_compute_dtype
from .vocoder import DEFAULT_NSF_CONFIG, Vocoder

FAMILIES = {"Sins": "ddsp", "CombSub": "ddsp", "CombSubFast": "ddsp",
            "CombSubSuperFast": "ddsp", "Diffusion": "unit2mel",
            "DiffusionNew": "diffusion", "DiffusionFast": "diffusion",
            "RectifiedFlow": "reflow"}


def model_family(model_type: str) -> str:
    """'ddsp', 'unit2mel', 'diffusion' or 'reflow' for a ``model.type``."""
    try:
        return FAMILIES[model_type]
    except KeyError:
        raise ValueError(f"unknown model type {model_type!r}: "
                         + ", ".join(FAMILIES)) from None


def build_model(args, vocoder_dimension: int = 128,
                dtype: torch.dtype | None = None) -> torch.nn.Module:
    """args: DotDict config (configs/*.yaml schema). Returns a module with
    uninitialised parameters. ``dtype``: the activations' type (bf16 mixed
    precision with ``torch.bfloat16``; the parameters stay float32), set on
    every layer as the JAX ``build_model(args, dtype=)`` passes it down. As
    in JAX, the config has no switch for the bf16 trunk on f32 activations:
    build ``Unit2WavFast`` / ``ReflowUnit2Wav`` with ``trunk_bf16=True``
    for B3. ``model.use_remat`` recomputes the cascades' denoiser layers in
    the backward (JAX registry.py:61)."""
    model = _build(args, vocoder_dimension)
    return set_compute_dtype(model, dtype) if dtype is not None else model


def _build(args, vocoder_dimension: int) -> torch.nn.Module:
    m, d = args.model, args.data
    model_family(m.type)
    remat = bool(m.use_remat)
    if m.type == "Sins":
        return Sins(d.sampling_rate, d.block_size, m.n_harmonics,
                    m.n_mag_allpass, m.n_mag_noise, d.encoder_out_channels,
                    m.n_spk)
    if m.type == "CombSub":
        return CombSub(d.sampling_rate, d.block_size, m.n_mag_allpass,
                       m.n_mag_harmonic, m.n_mag_noise, d.encoder_out_channels,
                       m.n_spk)
    if m.type == "CombSubFast":
        return CombSubFast(d.sampling_rate, d.block_size, d.encoder_out_channels,
                           m.n_spk)
    if m.type == "CombSubSuperFast":
        return CombSubSuperFast(d.sampling_rate, d.block_size, m.win_length,
                                d.encoder_out_channels, m.n_spk)
    if m.type == "Diffusion":
        return Unit2Mel(d.encoder_out_channels, m.n_spk, bool(m.use_pitch_aug),
                        vocoder_dimension, m.n_layers, m.n_chans, m.n_hidden,
                        k_step_max=m.k_step_max or 1000, remat=remat)
    if m.type == "DiffusionNew":
        return Unit2Wav(d.sampling_rate, d.block_size, d.encoder_out_channels,
                        m.n_spk, bool(m.use_pitch_aug), vocoder_dimension,
                        m.n_layers, m.n_chans, pcmer_norm=bool(m.pcmer_norm),
                        k_step_max=m.k_step_max or 1000, remat=remat)
    common = (d.sampling_rate, d.block_size, m.win_length,
              d.encoder_out_channels, m.n_spk, bool(m.use_pitch_aug),
              vocoder_dimension, m.n_layers, m.n_chans)
    if m.type == "DiffusionFast":
        return Unit2WavFast(*common, k_step_max=m.k_step_max or 1000,
                            remat=remat)
    return ReflowUnit2Wav(*common, remat=remat)


def load_model(model_path: str, device: str | torch.device | None = None):
    """A JAX checkpoint (``model_<step>.ckpt``) and its sibling config.yaml
    -> (module with the checkpoint's weights and buffers on ``device``, the
    CUDA card by default; args)."""
    from ..io.jax_params import load_state, model_state_dict, read_msgpack
    from ..utils.config import load_config

    dev = resolve_device(device)
    args = load_config(os.path.join(os.path.dirname(model_path), "config.yaml"))
    model = build_model(args, vocoder_dimension=args.model.out_dims or 128)
    payload = read_msgpack(model_path)
    load_state(model, model_state_dict(args.model, payload["params"],
                                       payload.get("buffers")))
    return model.to(dev), args


def load_vocoder(ckpt_path: str | None,
                 device: str | torch.device | None = None,
                 vocoder_type: str = "nsf-hifigan") -> Vocoder | None:
    """A converted NSF-HiFiGAN payload (``{"params", "config"}`` msgpack,
    as ``models/vocoder.load_vocoder_params`` reads it) -> Vocoder of
    ``vocoder_type`` on ``device`` (the CUDA card by default), or None when
    the file does not exist."""
    from ..io.jax_params import generator_state_dict, load_state, read_msgpack

    dev = resolve_device(device)
    if not ckpt_path:
        return None
    path = ckpt_path if ckpt_path.endswith(".msgpack") else ckpt_path + ".msgpack"
    if not os.path.exists(path):
        return None
    payload = read_msgpack(path)
    config = dict(DEFAULT_NSF_CONFIG)
    config.update(payload.get("config", {}))
    vocoder = Vocoder(vocoder_type, config)
    load_state(vocoder.model, generator_state_dict(
        payload["params"], len(config["upsample_rates"]),
        len(config["resblock_kernel_sizes"]),
        len(config["resblock_dilation_sizes"][0]), str(config["resblock"])))
    return vocoder.to(dev)


def load_vocoder_or_random(ckpt_path: str | None, seed: int = 0,
                           vocoder_type: str = "nsf-hifigan") -> Vocoder:
    """``load_vocoder`` on the CPU, or the default NSF-HiFiGAN with random
    weights from ``seed`` when the file does not exist (as the JAX
    wrapper's random init)."""
    from .nn import random_init_

    vocoder = load_vocoder(ckpt_path, device="cpu", vocoder_type=vocoder_type)
    if vocoder is None:
        print(f" [!] vocoder checkpoint {ckpt_path!r} not found - random init")
        vocoder = random_init_(Vocoder(vocoder_type),
                               torch.Generator().manual_seed(seed))
    return vocoder
