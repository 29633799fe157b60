"""Preprocess CLI (mirrors ddsp_svc_tpu/cli/preprocess.py):

    python -m ddsp_svc_tpu_torch.cli.preprocess -c configs/diffusion-fast.yaml

extracts the features of ``data.train_path`` then ``data.valid_path``: units
and the log-mel on the card (``--device``, the CUDA card by default), and
so is the config's f0 net (``data.f0_extractor`` rmvpe, crepe or fcpe);
a host tracker's f0 and the volume on the host. An f0 net without converted weights falls back to
YIN, and an encoder without converted weights gets random ones, with a
warning each. ``--seed`` seeds the augmentation draws (unseeded by
default, as in JAX) and those weights.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.preprocess import preprocess
from ..features.volume import VolumeExtractor
from ..utils.config import load_config
from ..utils.device import resolve_device
from .common import (build_f0_extractor, build_mel_extractor,
                     build_units_encoder, needs_mel)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--resume", action="store_true",
                        help="skip files whose outputs already exist")
    parser.add_argument("--device", default=None,
                        help="device of the units encoder and the mel "
                             "(default: the CUDA card)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the augmentation draws and of a units "
                             "encoder's random weights (default: unseeded "
                             "draws, as the JAX job; weights from seed 0)")
    cmd = parser.parse_args(argv)
    device = resolve_device(cmd.device)
    args = load_config(cmd.config)

    f0_extractor = build_f0_extractor(args, device)
    volume_extractor = VolumeExtractor(args.data.block_size)
    mel_extractor = build_mel_extractor(args, device) if needs_mel(args) else None
    units_encoder = build_units_encoder(args, device=device, seed=cmd.seed or 0)
    rng = np.random.default_rng(cmd.seed)
    for path in (args.data.train_path, args.data.valid_path):
        preprocess(path, f0_extractor, volume_extractor, mel_extractor,
                   units_encoder, sample_rate=args.data.sampling_rate,
                   hop_size=args.data.block_size,
                   use_pitch_aug=bool(args.model.use_pitch_aug),
                   extensions=tuple(args.data.extensions or ["wav"]),
                   rng=rng, skip_existing=cmd.resume, device=device)


if __name__ == "__main__":
    main()
