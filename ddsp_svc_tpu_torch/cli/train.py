"""Train CLI (mirrors ddsp_svc_tpu/cli/train.py):

    python -m ddsp_svc_tpu_torch.cli.train -c configs/diffusion-fast.yaml

builds the config's model with random weights from ``train.seed``, resumes
from the newest ``model_<step>.ckpt`` in ``env.expdir`` (a ``model_0``
dropped into a fresh expdir warm-starts it, shape-tolerantly), restores the
optimizer state where the checkpoint has it, and trains on ``--device``
(the CUDA card by default). Checkpoints are the JAX package's format.
``--max_steps`` ends the run after that many steps (the config's epochs
otherwise, as in JAX).

``train.amp_dtype`` bf16 / bfloat16 trains in bf16 mixed precision (the
parameters, the optimizer and the checkpoints stay float32, the
activations run in bf16); fp16 / float16 takes bf16 too, with the JAX
trainer's notice. ``model.use_remat: true`` recomputes each denoiser
layer's activations in its backward (``torch.utils.checkpoint``).

Data parallel, the counterpart of JAX's mesh over every device:

    torchrun --nproc_per_node N -m ddsp_svc_tpu_torch.cli.train -c CONFIG

Each of the N ranks (gloo; rank r on ``cuda:{LOCAL_RANK % cards}``, or
the CPU with ``--device cpu``) keeps B / N rows of every global batch, the
gradients are summed over the ranks, and every rank applies the same
update: the one-process update up to the order of the sums. A batch size
that N does not divide is refused (JAX drops devices instead; a launched
rank cannot be dropped). Rank 0 alone logs, validates and saves.
``JAX_COORDINATOR_ADDRESS`` without torchrun's environment is refused.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..models.nn import random_init_
from ..models.registry import build_model, model_family
from ..parallel import mesh as mesh_lib
from ..train import checkpoint as ckpt
from ..train.solver import train
from ..train.state import create_train_state, param_count, restore_opt_state
from ..utils.config import load_config
from ..utils.device import resolve_device
from .common import build_mel_extractor, needs_mel

MULTI_REFUSED = ("JAX_COORDINATOR_ADDRESS is set without torch.distributed's "
                 "environment: launch the ranks with torchrun (torchrun "
                 "--nproc_per_node N -m ddsp_svc_tpu_torch.cli.train -c CONFIG)")


def batch_refused(batch: int, world: int) -> str:
    return (f"batch_size {batch} is not divisible by the {world} ranks: "
            "every rank keeps batch_size / ranks rows of each batch")


def amp_dtype(args) -> torch.dtype | None:
    """``train.amp_dtype`` -> the activations' type, as the JAX trainer maps
    it (cli/train.py:71-76): bf16 / bfloat16 and fp16 / float16 (with its
    notice) to bfloat16, anything else to None (float32)."""
    amp = str(args.train.amp_dtype or "fp32").lower()
    if amp in ("fp16", "float16"):
        print(" [!] fp16 requested; using bf16 (the TPU-native low precision)")
        return torch.bfloat16
    return torch.bfloat16 if amp in ("bf16", "bfloat16") else None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--device", default=None,
                        help="device to train on (default: the CUDA card)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after this many steps of this run")
    cmd = parser.parse_args(argv)
    args = load_config(cmd.config)
    if not mesh_lib.launched():
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            raise SystemExit(MULTI_REFUSED)
        return _train(cmd, args, resolve_device(cmd.device), None)
    world = int(os.environ["WORLD_SIZE"])
    if int(args.train.batch_size) % world:
        raise SystemExit(batch_refused(int(args.train.batch_size), world))
    device = mesh_lib.join_launched_world(cmd.device)
    try:
        return _train(cmd, args, device, mesh_lib.make_mesh(device=device))
    finally:
        dist.destroy_process_group()


def _train(cmd, args, device, mesh):
    dtype = amp_dtype(args)

    model = build_model(args, vocoder_dimension=args.model.out_dims or 128,
                        dtype=dtype)
    random_init_(model, torch.Generator().manual_seed(int(args.train.seed or 0)),
                 training=True)
    print(f" [*] model: {args.model.type} ({model_family(args.model.type)})")

    initial_step, opt_payload = 0, None
    latest = ckpt.latest_checkpoint(args.env.expdir)
    if latest:
        payload, initial_step = ckpt.load_checkpoint(latest)
        ckpt.restore_into(model, args.model, payload)
        opt_payload = payload.get("opt_state")
        print(f" [*] resumed from {latest} (step {initial_step})")
    print(f" [*] parameters: {param_count(model):,}")
    model.to(device)
    if mesh is not None:
        mesh_lib.replicate(mesh, model)

    state = create_train_state(
        model, lr=float(args.train.lr),
        weight_decay=float(args.train.weight_decay or 0.0),
        decay_step=args.train.decay_step, gamma=args.train.gamma,
        start_step=initial_step)
    if opt_payload is not None:
        restore_opt_state(state, args.model, opt_payload)
    mel_fn = build_mel_extractor(args, device).extract if needs_mel(args) else None
    return train(args, state, mel_fn, initial_step=initial_step, device=device,
                 max_steps=cmd.max_steps, mesh=mesh)


if __name__ == "__main__":
    main()
