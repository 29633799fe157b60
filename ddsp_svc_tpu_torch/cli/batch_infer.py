"""Directory-recursive batch inference (mirrors
ddsp_svc_tpu/cli/batch_infer.py): every wav under an input tree converted
whole through one loaded ``SvcPipeline``, written to the same relative path
under the output tree.

python -m ddsp_svc_tpu_torch.cli.batch_infer -m exp/model_10000.ckpt \\
    -i in_dir -o out_dir [-id 1] [-k 0] [-th -60] [-pe yin] [-kstep 100] \\
    [-method dpm-solver] [-step 20] [--device cpu]

The files run in sorted order; each request draws its noise from the next
seed of the pipeline's sequence (seed 0), so a file's output is the one
``SvcPipeline.infer`` gives it with that seed alone.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..features.audio import load_wav, save_wav
from ..infer.pipeline import SvcPipeline
from ..utils.config import traverse_dir


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ddsp_svc_tpu_torch.cli.batch_infer",
        description="Convert every wav under a directory tree on the CUDA "
                    "card (or --device cpu), mirroring the tree.")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-id", "--spk_id", type=int, default=1)
    p.add_argument("-k", "--key", type=float, default=0.0)
    p.add_argument("-th", "--threhold", type=float, default=-60.0)
    p.add_argument("-pe", "--pitch_extractor", default="yin")
    p.add_argument("-kstep", "--k_step", type=int, default=None)
    p.add_argument("-method", "--method", default=None)
    p.add_argument("-step", "--infer_step", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Convert the tree; returns the relative paths written."""
    cmd = parse_args(argv)
    pipeline = SvcPipeline(cmd.model_path, device=cmd.device,
                           pitch_extractor=cmd.pitch_extractor)
    kwargs = {}
    if cmd.k_step:
        kwargs["k_step"] = cmd.k_step
    if cmd.method:
        kwargs["method"] = cmd.method
    if cmd.infer_step:
        kwargs["infer_step"] = cmd.infer_step
    files = traverse_dir(cmd.input_dir, extensions=["wav"], is_pure=True,
                         is_sort=True)
    print(f"{len(files)} files")
    for rel in files:
        audio, sr = load_wav(os.path.join(cmd.input_dir, rel))
        out, out_sr = pipeline.infer(audio.astype(np.float32), sr,
                                     spk_id=cmd.spk_id, key_shift=cmd.key,
                                     threhold=cmd.threhold, **kwargs)
        dst = os.path.join(cmd.output_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        save_wav(dst, out, out_sr)
        print(f"  {rel} -> {dst}")
    return files


if __name__ == "__main__":
    main()
