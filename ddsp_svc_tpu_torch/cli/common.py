"""Shared CLI helpers: the front-end built from a config (mirrors
ddsp_svc_tpu/cli/common.py ``load_encoder_params``, ``build_f0_extractor``,
``build_units_encoder``)."""
from __future__ import annotations

import os

import torch

from ..features.f0 import F0Extractor
from ..features.hubert import UnitsEncoder
from ..io.jax_params import load_params
from ..utils.config import DotDict


def load_encoder_params(path: str | None):
    """Converted flax params (.npz/.msgpack) if the file exists, else None
    (random init, with a warning when a path was given)."""
    if not path:
        return None
    params = load_params(path)
    if params is None:
        print(f" [!] encoder checkpoint {path!r} not found/convertible — "
              "using random init (convert with python -m ddsp_svc_tpu.convert)")
    return params


def build_f0_extractor(args: DotDict, device: str | torch.device | None = None
                       ) -> F0Extractor:
    """The config's f0 extractor on the model's hop grid, its net on
    ``device`` (the CUDA card by default); an f0 net without converted
    weights falls back to YIN with a warning."""
    kind = args.data.f0_extractor
    model_params = None
    pretrained = {"rmvpe": "pretrain/rmvpe/model.msgpack",
                  "crepe": "pretrain/crepe/full.msgpack"}
    if kind in pretrained:
        ckpt = pretrained[kind]
        if os.path.exists(ckpt):
            model_params = load_encoder_params(ckpt)
        else:
            print(f" [!] no converted {kind} weights found — falling back to "
                  "the built-in YIN extractor")
            kind = "yin"
    return F0Extractor(kind, sample_rate=args.data.sampling_rate,
                       hop_size=args.data.block_size, f0_min=args.data.f0_min,
                       f0_max=args.data.f0_max, model_params=model_params,
                       device=device)


def build_units_encoder(args: DotDict, device: str | torch.device | None = None,
                        seed: int = 0) -> UnitsEncoder:
    """The config's units encoder on ``device`` (the CUDA card by default),
    with its converted weights or random ones from ``seed``."""
    return UnitsEncoder(
        args.data.encoder,
        params=load_encoder_params(args.data.encoder_ckpt),
        encoder_sample_rate=args.data.encoder_sample_rate,
        encoder_hop_size=args.data.encoder_hop_size,
        cnhubertsoft_gate=args.data.cnhubertsoft_gate or 10,
        device=device, seed=seed)


def build_mel_extractor(args: DotDict, device: str | torch.device = "cpu"):
    """The vocoder's log-mel for the config's rate and hop (128 mels, n_fft
    2048, 40-16000 Hz), on ``device``: the cascades' training mel and the
    preprocess job's (JAX ``build_mel_extractor``)."""
    from ..ops.mel import LogMelSpectrogram

    return LogMelSpectrogram(sr=args.data.sampling_rate, n_mels=128,
                             n_fft=2048, win_size=2048,
                             hop_length=args.data.block_size, fmin=40.0,
                             fmax=16000.0).to(device)


def needs_mel(args: DotDict) -> bool:
    return args.model.type in ("Diffusion", "DiffusionNew", "DiffusionFast",
                               "RectifiedFlow")
