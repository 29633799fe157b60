"""NSF-HiFiGAN GAN training CLI (mirrors ddsp_svc_tpu/cli/train_vocoder.py):

    python -m ddsp_svc_tpu_torch.cli.train_vocoder -c configs/nsf-hifigan.yaml

reads a diffusion-family preprocess run (``audio/``, ``f0/``, ``mel/``),
merges the config's ``vocoder`` section over the default NSF-HiFiGAN
config, and trains the weight-normed generator against MPD + MSD on
``--device`` (the CUDA card by default). ``expdir/model_<step>.ckpt`` is
the JAX package's payload, ``{"params": {"generator", "discriminator"},
"opt_state": {...}}``, read and written both ways; the newest one is
resumed with both optimizer states. Logs every ``train.interval_log``
steps, saves every ``train.interval_val``; ``--max_steps`` ends the run
after that many steps. A resumed run folds the data seed and the source's
noise stream with its step, as ``cli.train`` does.

Data parallel as ``cli.train`` (JAX's mesh over every device,
cli/train_vocoder.py:144-156): ``torchrun --nproc_per_node N -m
ddsp_svc_tpu_torch.cli.train_vocoder -c CONFIG``; each rank keeps B / N
rows of each batch in both GAN steps, rank 0 alone logs and saves.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.dataset import AudioDataset, BatchSampler
from ..io import msgpack_codec
from ..models.nn import random_init_
from ..models.nsf_hifigan import Generator
from ..models.vocoder import DEFAULT_NSF_CONFIG
from ..ops.mel import LogMelSpectrogram
from ..parallel import mesh as mesh_lib
from ..train import checkpoint as ckpt
from ..train.saver import Saver
from ..train.solver import stream_generator
from ..train.steps import to_device
from ..train.vocoder_solver import (Discriminators, create_states, disc_step,
                                    gen_step, restore_payload, vocoder_payload)
from ..utils.config import load_config
from ..utils.device import resolve_device
from .train import batch_refused

NO_DISCRIMINATOR = (
    "config error: discriminator_periods=[] with msd_scales=0 disables every "
    "sub-discriminator; this trainer is the GAN recipe (nsf_hifigan/models.py) "
    "and needs at least one of MPD periods or MSD scales")


def vocoder_config(args) -> dict:
    """The default NSF-HiFiGAN config with the config's ``vocoder`` keys
    over it, at the data's rate and hop."""
    cfg = dict(DEFAULT_NSF_CONFIG)
    if args.vocoder:
        cfg.update({k: v for k, v in dict(args.vocoder).items() if k in cfg})
    cfg["sampling_rate"] = args.data.sampling_rate
    cfg["hop_size"] = args.data.block_size
    return cfg


def discriminator_config(args) -> tuple[tuple, int]:
    """(periods, MSD scales): the recipe's (2, 3, 5, 7, 11) and 3 unless
    the config sets ``vocoder.discriminator_periods`` / ``msd_scales``; an
    empty list and 0 are settings, and both at once is refused."""
    periods_cfg = args.vocoder.discriminator_periods if args.vocoder else None
    msd_cfg = args.vocoder.msd_scales if args.vocoder else None
    periods = tuple((2, 3, 5, 7, 11) if periods_cfg is None else periods_cfg)
    msd = 3 if msd_cfg is None else int(msd_cfg)
    if not periods and not msd:
        raise SystemExit(NO_DISCRIMINATOR)
    return periods, msd


def build_generator(cfg: dict) -> Generator:
    return Generator(
        cfg["sampling_rate"], num_mels=cfg["num_mels"],
        upsample_rates=tuple(cfg["upsample_rates"]),
        upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
        upsample_initial_channel=cfg["upsample_initial_channel"],
        resblock=str(cfg["resblock"]),
        resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in cfg["resblock_dilation_sizes"]),
        weight_norm=True)


def build_mel(cfg: dict) -> LogMelSpectrogram:
    return LogMelSpectrogram(sr=cfg["sampling_rate"], n_mels=cfg["num_mels"],
                             n_fft=cfg["n_fft"], win_size=cfg["win_size"],
                             hop_length=cfg["hop_size"], fmin=cfg["fmin"],
                             fmax=cfg["fmax"])


def save(expdir: str, payload: dict) -> str:
    os.makedirs(expdir, exist_ok=True)
    path = os.path.join(expdir, f"model_{payload['global_step']}.ckpt")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(msgpack_codec.packb(payload))
    os.replace(tmp, path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--fused_resblocks", action="store_true",
                        help="accepted for the JAX CLI's sake and ignored: "
                             "on the card the generator's ResBlock1 stages "
                             "run kernel K2 (its backward the plain chain) "
                             "either way, as on the serving path")
    parser.add_argument("--device", default=None,
                        help="device to train on (default: the CUDA card)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after this many steps of this run")
    cmd = parser.parse_args(argv)
    args = load_config(cmd.config)
    if not mesh_lib.launched():
        return _train(cmd, args, resolve_device(cmd.device), None)
    world = int(os.environ["WORLD_SIZE"])
    if int(args.train.batch_size) % world:
        raise SystemExit(batch_refused(int(args.train.batch_size), world))
    device = mesh_lib.join_launched_world(cmd.device)
    try:
        return _train(cmd, args, device, mesh_lib.make_mesh(device=device))
    finally:
        torch.distributed.destroy_process_group()


def _train(cmd, args, device, mesh):
    cfg = vocoder_config(args)
    periods, msd = discriminator_config(args)

    seed = int(args.train.seed or 0)
    gen = random_init_(build_generator(cfg), torch.Generator().manual_seed(seed))
    discs = random_init_(Discriminators(periods, msd),
                         torch.Generator().manual_seed(seed + 1))
    mel_fn = build_mel(cfg).to(device).extract
    ds = AudioDataset(args.data.train_path, waveform_sec=args.data.duration,
                      hop_size=args.data.block_size,
                      sample_rate=args.data.sampling_rate,
                      load_all_data=bool(args.train.cache_all_data),
                      with_mel=True, use_aug=False)
    batch_size = int(args.train.batch_size)
    gen, discs = gen.to(device), discs.to(device)
    if mesh is not None:
        mesh_lib.replicate(mesh, gen)
        mesh_lib.replicate(mesh, discs)
    state_g, state_d = create_states(gen, discs, float(args.train.lr))
    lead = mesh is None or mesh.rank == 0
    saver = Saver(args, initial_global_step=0) if lead else None
    start = 0
    latest = ckpt.latest_checkpoint(args.env.expdir)
    if latest:
        payload, start = ckpt.load_checkpoint(latest)
        restore_payload(state_g, state_d, cfg, payload)
        print(f" [*] resumed from {latest} (step {start})")
    if lead:
        saver.global_step = start
    sampler = BatchSampler(ds, batch_size, seed=start)
    rng = stream_generator(seed, start, device)
    interval_log = int(args.train.interval_log or 10)
    interval_val = int(args.train.interval_val or 2000)
    total = int(args.train.epochs or 1) * max(len(sampler.files) // batch_size, 1)
    if cmd.max_steps is not None:
        total = min(total, start + cmd.max_steps)
    step = start
    while step < total:
        batch = to_device(_vocoder_batch(sampler.sample()), device)
        md = disc_step(state_d, state_g.model, batch, rng=rng, mesh=mesh)
        mg = gen_step(state_g, state_d.model, batch, mel_fn, rng=rng, mesh=mesh)
        step += 1
        if lead:
            saver.global_step_increment()
        if step % interval_log == 0:
            dl, gl = float(md["disc_loss"]), float(mg["gen_loss"])
            mel_l1 = float(mg["mel_l1"])
            if not (np.isfinite(dl) and np.isfinite(gl)):
                raise ValueError(" [x] nan loss ")
            if lead:
                saver.log_info(
                    f"step: {step} | d: {dl:.4f} | g: {gl:.4f} | "
                    f"mel_l1: {mel_l1:.4f} | time: {saver.get_total_time()}")
                saver.log_value({"vocoder/disc_loss": dl, "vocoder/gen_loss": gl,
                                 "vocoder/mel_l1": mel_l1})
        if step % interval_val == 0:
            if lead:
                save(args.env.expdir, vocoder_payload(state_g, state_d, cfg, step))
                saver.log_info(f" [*] vocoder ckpt saved at {step}")
            if mesh is not None:
                mesh.world.barrier()  # the others wait while rank 0 saves
    return state_g, state_d


def _vocoder_batch(batch: dict) -> dict:
    return {k: batch[k] for k in ("audio", "mel", "f0")}


if __name__ == "__main__":
    main()
