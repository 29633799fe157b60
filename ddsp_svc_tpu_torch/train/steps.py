"""Train steps for every model family (mirrors ddsp_svc_tpu/train/steps.py):
one step is the forward, the loss, the backward and one AdamW update, and
returns the loss terms as the JAX steps return them.

  - DDSP synths: the RSS multi-scale spectral loss on the waveform;
  - diffusion cascades: lambda_ddsp x MSE(ddsp mel, gt mel) + the diffusion
    loss;
  - Unit2Mel: the diffusion loss alone;
  - the reflow cascade: lambda_ddsp x MSE + the log-normal weighted flow
    loss.

Data parallel (JAX's jit over a ``data`` mesh axis, solver.py:203-212):
with a ``mesh`` (``parallel/mesh.make_mesh``) every rank is given the same
global batch, keeps its rows (``shard_batch``), and takes the gradient of
its rows' share of the global mean loss; the gradients (and the loss terms,
for the metrics) are summed over the data axis in one flattened buffer,
and every rank applies the same AdamW update. Without a mesh the step is
the one-process step, the same code with one shard.

Every draw of a step is made at the global batch's shape, in a fixed
order, from ``generator`` (the same seed on every rank), and sliced like
the batch, so the update does not depend on the number of ranks. Each can
be injected through ``draws``, at the global shape: the synth's noise
``noise`` / ``ddsp_noise``, the diffusion ``t`` and ``noise``, the reflow
``t`` (clipped) and ``x_0``, the RSS ``rss_idx``. Kernels K1, K3 (or
B3 / B5) and K4 launch once per forward through their
``autograd.Function``s, whose backward is the plain chain.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.losses import RSSLoss
from ..parallel.mesh import batch_sharding, shard_batch
from ..parallel.stream_core import default_draw
from .state import TrainState


def to_device(batch: dict, device) -> dict:
    """A numpy batch -> tensors on ``device`` (spk_id as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def global_draws(plan: dict, draws: dict | None, generator, device) -> dict:
    """The step's draws at the global shape: ``plan`` {name: (shape, kind)}
    in drawing order ('normal', 'uniform', or ('randint', high), or a
    function of the generator and device), an injected draw in place of
    its entry (and drawing nothing for it)."""
    out = {}
    for name, (shape, kind) in plan.items():
        if draws is not None and draws.get(name) is not None:
            out[name] = torch.as_tensor(draws[name], device=device)
        elif callable(kind):
            out[name] = kind(shape, generator, device)
        elif isinstance(kind, tuple):
            out[name] = torch.randint(0, kind[1], shape, generator=generator,
                                      device=device)
        else:
            out[name] = default_draw(shape, kind, generator, device)
    return out


def data_group(mesh):
    """The group a data-parallel step sums its gradients over."""
    return None if mesh is None else mesh.data


def shard(mesh, batch: dict, draws: dict, per_row: tuple) -> tuple:
    """-> (this rank's rows of the batch, of each per-row draw (the others
    whole), its share B_local / B of the global batch)."""
    if mesh is None:
        return batch, draws, 1.0
    local = {k: v[batch_sharding(mesh, tuple(v.shape))] if k in per_row else v
             for k, v in draws.items()}
    b = next(iter(batch.values())).shape[0]
    return shard_batch(mesh, batch), local, (b // mesh.dp) / b


def apply_update(state: TrainState, loss: torch.Tensor, terms: list,
                 group=None) -> list:
    """Backward of this rank's ``loss``, the gradients (and the detached
    loss ``terms``) summed over ``group``'s ranks (a ``mesh.TimeGroup``;
    None: one process) in one buffer, one AdamW step -> the summed terms.
    A parameter without a gradient has none on any rank (every rank builds
    the same graph) and is skipped, as in one process."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    terms = [t.detach().float().reshape(1) for t in terms]
    if group is not None:
        params = [p for p in state.model.parameters() if p.grad is not None]
        summed = group.psum_flat([p.grad for p in params] + terms)
        for p, g in zip(params, summed):
            p.grad = g
        terms = summed[len(params):]
    state.apply_gradients()
    return [t[0] for t in terms]


def make_ddsp_train_step(loss_fft_min: int = 256, loss_fft_max: int = 2048,
                         n_scale: int = 4, mesh=None) -> Callable:
    """Train step for Sins / CombSub* models."""
    rss = RSSLoss(loss_fft_min, loss_fft_max, n_scale)

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        b, n = batch["audio"].shape
        d = global_draws({"noise": ((b, n), state.model.NOISE),
                          "rss_idx": ((rss.n_scale,), ("randint", len(rss.sizes)))},
                         draws, generator, batch["audio"].device)
        batch, d, share = shard(mesh, batch, d, ("noise",))
        signal, _ = state.model(batch["units"], batch["f0"], batch["volume"],
                                spk_id=batch.get("spk_id"), noise=d["noise"])
        loss = rss(signal, batch["audio"], d["rss_idx"]) * share
        (total,) = apply_update(state, loss, [loss], data_group(mesh))
        return {"loss": total}

    step.rss = rss
    return step


def make_cascade_train_step(mel_extract_fn: Callable, lambda_ddsp: float = 1.0,
                            k_step_max: int | None = None,
                            family: str = "diffusion",
                            t_start: float = 0.0, mesh=None) -> Callable:
    """Train step for Unit2Wav / Unit2WavFast ('diffusion') and
    ReflowUnit2Wav ('reflow'); the batch may carry ``aug_shift``."""

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        model = state.model
        b, t, m = batch["mel"].shape
        plan = {"ddsp_noise": ((b, t * model.ddsp_model.block_size),
                               model.ddsp_model.NOISE)}
        if family == "diffusion":
            plan["t"] = ((b,), ("randint", model.diff_model.k_step
                                if k_step_max is None else int(k_step_max)))
            plan["noise"] = ((b, t, m), "normal")
        else:
            plan["t"] = ((b,), reflow_t(t_start))
            plan["x_0"] = ((b, t, m), "normal")
        d = global_draws(plan, draws, generator, batch["mel"].device)
        batch, d, share = shard(mesh, batch, d, tuple(plan))
        kwargs = dict(mel_extract_fn=mel_extract_fn, spk_id=batch.get("spk_id"),
                      aug_shift=batch.get("aug_shift"), **d)
        if family == "diffusion":
            kwargs.update(k_step=k_step_max)
        else:
            kwargs.update(t_start=t_start)
        ddsp_loss, diff_loss = model.loss(
            batch["units"], batch["f0"], batch["volume"], batch["mel"], **kwargs)
        ddsp_loss, diff_loss = ddsp_loss * share, diff_loss * share
        loss = lambda_ddsp * ddsp_loss + diff_loss
        ddsp_total, diff_total = apply_update(state, loss, [ddsp_loss, diff_loss],
                                              data_group(mesh))
        return {"loss": lambda_ddsp * ddsp_total + diff_total,
                "ddsp_loss": ddsp_total, "diff_loss": diff_total}

    return step


def reflow_t(t_start: float) -> Callable:
    """The flow's t, drawn as the model draws it: t_start + (1 - t_start)
    U(0, 1), clipped to [1e-7, 1 - 1e-7]."""
    t0 = max(float(t_start), 0.0)

    def draw_t(shape, generator, device):
        u = torch.rand(shape, generator=generator, device=device)
        return torch.clamp(t0 + (1.0 - t0) * u, 1e-7, 1.0 - 1e-7)

    return draw_t


def make_unit2mel_train_step(k_step_max: int | None = None, mesh=None) -> Callable:
    """Train step for the pure-diffusion Unit2Mel."""

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        b, t, m = batch["mel"].shape
        t_max = state.model.decoder.k_step if k_step_max is None else int(k_step_max)
        plan = {"t": ((b,), ("randint", t_max)), "noise": ((b, t, m), "normal")}
        d = global_draws(plan, draws, generator, batch["mel"].device)
        batch, d, share = shard(mesh, batch, d, tuple(plan))
        loss = state.model.loss(batch["units"], batch["f0"], batch["volume"],
                                batch["mel"], spk_id=batch.get("spk_id"),
                                aug_shift=batch.get("aug_shift"),
                                k_step=k_step_max, **d) * share
        (total,) = apply_update(state, loss, [loss], data_group(mesh))
        return {"loss": total}

    return step
