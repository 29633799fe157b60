"""Validation-set sampler (mirrors ddsp_svc_tpu/cli/draw.py): move a few
random wavs longer than a minimum duration from data/train to data/val.

    python -m ddsp_svc_tpu_torch.cli.draw [-c config.yaml] [-n 2] [--min-sec 2]
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..features.audio import load_wav
from ..utils.config import load_config, traverse_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--train", default="data/train")
    p.add_argument("--val", default="data/val")
    p.add_argument("-n", "--num", type=int, default=2)
    p.add_argument("--min-sec", type=float, default=2.0)
    cmd = p.parse_args(argv)

    train_path, val_path = cmd.train, cmd.val
    if cmd.config:
        args = load_config(cmd.config)
        train_path, val_path = args.data.train_path, args.data.valid_path
    src_dir = os.path.join(train_path, "audio")
    files = traverse_dir(src_dir, extensions=["wav"], is_pure=True, is_sort=True)
    rng = np.random.default_rng()
    eligible = []
    for rel in files:
        audio, sr = load_wav(os.path.join(src_dir, rel))
        if len(audio) / sr > cmd.min_sec:
            eligible.append(rel)
    if not eligible:
        print("no eligible files (all too short)")
        return
    picks = rng.choice(len(eligible), min(cmd.num, len(eligible)), replace=False)
    for i in picks:
        rel = eligible[int(i)]
        dst = os.path.join(val_path, "audio", rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.move(os.path.join(src_dir, rel), dst)
        print(f"moved {rel} -> val")


if __name__ == "__main__":
    main()
