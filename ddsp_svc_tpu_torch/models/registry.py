"""Model construction from the reference YAML schema (mirrors
ddsp_svc_tpu/models/registry.py ``build_model``/``load_model`` for the
DiffusionFast family only)."""
from __future__ import annotations

import os

import torch

from .cascade import Unit2WavFast
from .vocoder import DEFAULT_NSF_CONFIG, Vocoder


def build_model(args, vocoder_dimension: int = 128) -> Unit2WavFast:
    """args: DotDict config (configs/diffusion-fast.yaml schema). Returns a
    module with uninitialised parameters."""
    if args.model.type != "DiffusionFast":
        raise NotImplementedError(
            f"model type {args.model.type!r}: only DiffusionFast is ported")
    return Unit2WavFast(
        args.data.sampling_rate, args.data.block_size, args.model.win_length,
        args.data.encoder_out_channels, args.model.n_spk,
        bool(args.model.use_pitch_aug), vocoder_dimension,
        args.model.n_layers, args.model.n_chans)


def load_model(model_path: str, device: torch.device | str = "cpu"):
    """A JAX checkpoint (``model_<step>.ckpt``) and its sibling config.yaml
    -> (module with the checkpoint's weights, args)."""
    from ..io.jax_params import load_state, read_msgpack, unit2wav_fast_state_dict
    from ..utils.config import load_config

    args = load_config(os.path.join(os.path.dirname(model_path), "config.yaml"))
    model = build_model(args, vocoder_dimension=args.model.out_dims or 128)
    payload = read_msgpack(model_path)
    load_state(model, unit2wav_fast_state_dict(payload["params"],
                                               args.model.n_layers))
    return model.to(device), args


def load_vocoder(ckpt_path: str | None, device: torch.device | str = "cpu"
                 ) -> Vocoder | None:
    """A converted NSF-HiFiGAN payload (``{"params", "config"}`` msgpack,
    as ``models/vocoder.load_vocoder_params`` reads it) -> Vocoder, or None
    when the file does not exist."""
    from ..io.jax_params import generator_state_dict, load_state, read_msgpack

    if not ckpt_path:
        return None
    path = ckpt_path if ckpt_path.endswith(".msgpack") else ckpt_path + ".msgpack"
    if not os.path.exists(path):
        return None
    payload = read_msgpack(path)
    config = dict(DEFAULT_NSF_CONFIG)
    config.update(payload.get("config", {}))
    vocoder = Vocoder("nsf-hifigan", config)
    load_state(vocoder.model, generator_state_dict(
        payload["params"], len(config["upsample_rates"]),
        len(config["resblock_kernel_sizes"]),
        len(config["resblock_dilation_sizes"][0])))
    return vocoder.to(device)
