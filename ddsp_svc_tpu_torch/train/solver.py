"""The training loop for every model family (mirrors
ddsp_svc_tpu/train/solver.py: ``FAMILIES``, ``build_train_step``,
``validate``, ``train``).

  family 'ddsp'      -- RSS spectral loss on the waveform
  family 'unit2mel'  -- pure mel diffusion
  family 'diffusion' -- cascade: lambda_ddsp x MSE + diffusion loss
  family 'reflow'    -- cascade with the log-normal flow loss, and mel
                        SNR / PSNR / SI-SNR in validation

One step per batch; batches from ``data/dataset.BatchSampler``, or for an
uncached corpus without mels (``cache_all_data`` false, the DDSP family)
from ``data/prefetch.PrefetchBatchSampler``, the C++ prefetcher that reads
the crops while the card runs the previous step and gives the same batches
bit for bit (the JAX solver's choice, solver.py:174-181). The data seed
and the model-noise stream are folded with the resumed step, so a resumed
run draws fresh batches and noise. A NaN loss raises.
Validation runs under ``torch.no_grad``.

Data parallel (a ``mesh`` of ``torchrun``'s ranks): every rank draws the
same global batch from the same seed and the step keeps its rows
(``train/steps.py``); rank 0 alone logs, validates and saves, while the
other ranks wait at a barrier. JAX's multi-host loader gives each process
``files[rank::world]`` (solver.py:166-168) instead; the port does not, so
that the update is the one-process update whatever the world size.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..data.dataset import AudioDataset, BatchSampler, get_datasets
from ..models.registry import FAMILIES, model_family  # noqa: F401 (re-export)
from ..ops.losses import mel_psnr, mel_si_snr, mel_snr, rss_loss
from .saver import Saver
from .state import TrainState, opt_state_to_optax
from .steps import (make_cascade_train_step, make_ddsp_train_step,
                    make_unit2mel_train_step, to_device)


def build_train_step(args, mel_extract_fn=None, mesh=None):
    """-> (family, step function) for ``args.model.type``; with a ``mesh``
    the data-parallel step."""
    family = model_family(args.model.type)
    if family == "ddsp":
        loss_cfg = args.loss or {}
        return family, make_ddsp_train_step(loss_cfg.get("fft_min", 256),
                                            loss_cfg.get("fft_max", 2048),
                                            loss_cfg.get("n_scale", 4), mesh=mesh)
    if family == "unit2mel":
        return family, make_unit2mel_train_step(args.model.k_step_max or 1000,
                                                mesh=mesh)
    t_start = float(args.model.t_start or 0.0) if family == "reflow" else 0.0
    return family, make_cascade_train_step(
        mel_extract_fn, lambda_ddsp=float(args.train.lambda_ddsp or 1.0),
        k_step_max=(args.model.k_step_max or 1000) if family == "diffusion" else None,
        family=family, t_start=t_start, mesh=mesh)


def stream_generator(seed: int, step: int, device) -> torch.Generator:
    """The model-noise stream of a run resumed at ``step``."""
    mixed = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


@torch.no_grad()
def validate(args, family: str, model, valid: AudioDataset, saver: Saver,
             device, mel_extract_fn=None) -> dict:
    """A full-length pass over the validation files: loss / mel metrics and
    the real-time factor."""
    results, total_rtf = {}, []
    rng = np.random.default_rng(0)
    for num, name_ext in enumerate(valid.paths):
        item = valid.sample_crop(name_ext, rng)
        batch = to_device({k: v[None] for k, v in item.items() if k != "name"},
                          device)
        gen = torch.Generator(device=device).manual_seed(num)
        start = time.time()
        if family == "ddsp":
            signal, _ = model(batch["units"], batch["f0"], batch["volume"],
                              spk_id=batch.get("spk_id"), generator=gen)
            loss = float(rss_loss(signal, batch["audio"], generator=gen))
            run_time = time.time() - start
            metrics = {"validation/loss": loss}
            saver.log_audio({f"{name_ext}/audio": signal[0].cpu().numpy()})
            song_time = signal.shape[-1] / args.data.sampling_rate
        else:
            if family == "unit2mel":
                mel_pred = model(batch["units"], batch["f0"], batch["volume"],
                                 spk_id=batch.get("spk_id"), gt_spec=batch["mel"],
                                 infer_speedup=args.infer.speedup or 10,
                                 sampler=args.infer.method or "dpm-solver",
                                 k_step=args.model.k_step_max or 1000,
                                 generator=gen)
            elif family == "diffusion":
                mel_pred = model(batch["units"], batch["f0"], batch["volume"],
                                 mel_extract_fn=mel_extract_fn,
                                 spk_id=batch.get("spk_id"),
                                 infer_speedup=args.infer.speedup or 10,
                                 sampler=args.infer.method or "dpm-solver",
                                 k_step=args.model.k_step_max or 1000,
                                 generator=gen)
            else:
                mel_pred = model(batch["units"], batch["f0"], batch["volume"],
                                 mel_extract_fn=mel_extract_fn,
                                 spk_id=batch.get("spk_id"),
                                 infer_step=args.infer.infer_step or 10,
                                 sampler=args.infer.method or "euler",
                                 t_start=float(args.model.t_start or 0.0),
                                 generator=gen)
            gt = batch["mel"]
            metrics = {"validation/mse": float(torch.mean((mel_pred - gt) ** 2)),
                       "validation/snr": float(mel_snr(gt, mel_pred)),
                       "validation/si_snr": float(mel_si_snr(gt, mel_pred)),
                       "validation/psnr": float(mel_psnr(gt, mel_pred))}
            run_time = time.time() - start
            saver.log_spec(f"{name_ext}/spec", gt.cpu().numpy(),
                           mel_pred.cpu().numpy())
            song_time = (mel_pred.shape[1] * args.data.block_size
                         / args.data.sampling_rate)
        total_rtf.append(run_time / max(song_time, 1e-9))
        for k, v in metrics.items():
            results[k] = results.get(k, 0.0) + v
    n = max(len(valid.paths), 1)
    results = {k: v / n for k, v in results.items()}
    results["validation/rtf"] = float(np.mean(total_rtf)) if total_rtf else 0.0
    return results


def make_sampler(args, train_ds: AudioDataset, seed: int):
    """The training batches: the C++ prefetcher for an uncached corpus
    without mels, where each step would otherwise wait on the crops' reads,
    else ``BatchSampler`` (the JAX solver's choice)."""
    batch_size = int(args.train.batch_size)
    if not bool(args.train.cache_all_data) and not train_ds.with_mel:
        from ..data.prefetch import PrefetchBatchSampler

        return PrefetchBatchSampler(train_ds, batch_size, seed=seed)
    return BatchSampler(train_ds, batch_size, seed=seed)


def train(args, state: TrainState, mel_extract_fn=None, initial_step: int = 0,
          device="cuda", max_steps: int | None = None, mesh=None) -> TrainState:
    """The main loop: sample, step, log every ``interval_log``, save,
    retain and validate every ``interval_val``. ``max_steps`` ends the run
    after that many steps of this call (the JAX loop runs to its epochs).
    With a ``mesh`` this is one rank of a data-parallel run."""
    device = torch.device(device)
    family, step_fn = build_train_step(args, mel_extract_fn, mesh)
    lead = mesh is None or mesh.rank == 0
    saver = Saver(args, initial_global_step=initial_step) if lead else None
    train_ds, valid_ds = get_datasets(args)
    sampler = make_sampler(args, train_ds, int(args.train.seed or 0) + initial_step)
    if lead:
        saver.log_info(f" [*] {len(train_ds)} train files, {len(valid_ds)} "
                       f"valid files" + (f", {mesh.dp} data-parallel ranks"
                                         if mesh is not None else ""))

    interval_log = int(args.train.interval_log or 10)
    interval_val = int(args.train.interval_val or 2000)
    interval_force_save = int(args.train.interval_force_save or 0)
    save_opt = bool(args.train.save_opt)
    epochs = int(args.train.epochs or 100000)
    steps_per_epoch = max(len(sampler.files) // int(args.train.batch_size), 1)
    total_steps = epochs * steps_per_epoch
    if max_steps is not None:
        total_steps = min(total_steps, initial_step + int(max_steps))
    generator = stream_generator(int(args.train.seed or 0), initial_step, device)
    last_saved_step = -1
    state.model.train()
    step = initial_step

    while step < total_steps:
        batch = to_device(sampler.sample(), device)
        metrics = step_fn(state, batch, generator)
        step += 1
        if lead:
            saver.global_step_increment()

        if step % interval_log == 0:
            loss = float(metrics["loss"])  # the same on every rank
            if np.isnan(loss):
                raise ValueError(" [x] nan loss ")
            if lead:
                saver.log_info(
                    f"step: {step} | loss: {loss:.6f} | lr: "
                    f"{state.lr():.3e} | time: {saver.get_total_time()} | "
                    f"{interval_log / max(saver.get_interval_time(), 1e-9):.2f} it/s")
                saver.log_value({f"train/{k}": float(v) for k, v in metrics.items()})

        if step % interval_val == 0:
            if lead:
                saver.save_model(state.model, opt_state_to_optax(state, args.model)
                                 if save_opt else None)
                if last_saved_step >= 0 and (interval_force_save <= 0 or
                                             last_saved_step % interval_force_save != 0):
                    saver.delete_model(last_saved_step)
                last_saved_step = step
                state.model.eval()
                results = validate(args, family, state.model, valid_ds, saver,
                                   device, mel_extract_fn)
                state.model.train()
                saver.log_info({"validation": results})
                saver.log_value(results)
            if mesh is not None:
                mesh.world.barrier()  # the others wait while rank 0 saves
    return state
