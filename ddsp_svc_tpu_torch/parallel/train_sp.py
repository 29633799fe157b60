"""The sequence-parallel (dp x sp) training step of the DiffusionFast and
reflow cascades (mirrors ddsp_svc_tpu/parallel/train_sp.py
``make_sp_cascade_train_step``).

Rank (d, s) of a ``mesh.Mesh`` holds rows [d B / dp, (d + 1) B / dp) and
frames [s T / sp, (s + 1) T / sp) of the batch, and runs the whole loss
on that block: the DDSP stage through the streamed CombSubSuperFast
(``stream_combsub._combsub_block``, K1 once per rank), the blocked
log-mel, and the denoiser on DENOISER_HALO frames of halo on each side
with its ``edge_mask`` (the masked stock chain: K3 does not launch, as
JAX's dispatch sends a masked layer away from its fused kernel). The
halos, GroupNorm's statistics and the phase carry cross the time group
under autograd (``mesh.TimeGroup``'s differentiable collectives), so
each rank's backward of its local loss gives its exact share of the
global gradient. As in JAX, no collective sits on the loss itself (its
transpose would scale every gradient by the world size): the local
losses' gradients, and the loss terms, are summed over the whole world
in one flattened buffer outside the backward, and every rank applies the
same AdamW update.

Every rank is given the global batch and the global draws (made from the
same seed on every rank when not injected): the DDSP noise (B, T hop),
the diffusion t (B,) and noise (B, T, M), or the reflow t (B,) and x_0
(B, T, M), and takes its block of each, so the step does not depend on
(dp, sp) up to the order of the sums. JAX draws them per frame and per
data shard from split keys (train_sp.py:104-121, 209-212); its draws can
be injected here as arrays. Dropout does not run (JAX turns it off in
this step; the port applies none anyway).
"""
from __future__ import annotations

import numpy as np
import torch

from ..train.state import TrainState
from ..train.steps import apply_update, global_draws, reflow_t
from .mesh import batch_sharding, shard_batch
from .stream_combsub import _combsub_block
from .stream_core import DENOISER_HALO, FRAME_HALO, _blocked_logmel, _frame_halo


def make_sp_cascade_train_step(model, mel, world, lambda_ddsp: float = 1.0,
                               k_step_max: int | None = None,
                               family: str = "diffusion",
                               t_start: float = 0.0):
    """-> step(state, batch, generator=None, draws=None) -> metrics.

    ``model``: Unit2WavFast ('diffusion') or ReflowUnit2Wav ('reflow');
    ``mel``: the vocoder's ``LogMelSpectrogram`` (hop == block size,
    n_fft == win_size); ``world``: this rank's ``mesh.Mesh``. ``batch``:
    the global units, f0, volume and mel (B, T, ...), optional spk_id
    (B, 1) and aug_shift (B, 1, 1). ``draws``: global ``ddsp_noise``, ``t``
    and ``noise`` (diffusion) or ``x_0`` (reflow). Asserted, with JAX's
    messages: B divisible by dp, T by sp, and at least max(FRAME_HALO,
    DENOISER_HALO) frames per time block."""
    dp, sp = world.dp, world.sp
    hd = DENOISER_HALO
    net = model.velocity_fn if family == "reflow" else model.denoise_fn
    norm = model.reflow_model if family == "reflow" else model.diff_model
    if family == "diffusion":
        sched = norm.schedule()
        c0_tab, c1_tab = (torch.as_tensor(sched[k].astype(np.float32)) for k in
                          ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"))
        t_max = norm.k_step if k_step_max is None else int(k_step_max)

    def step(state: TrainState, batch: dict, generator=None, draws=None):
        b, t, m_dims = batch["mel"].shape
        if b % dp:
            raise ValueError(f"batch {b} not divisible by dp {dp}")
        if t % sp:
            raise ValueError(f"frames {t} not divisible by sp {sp}")
        need = max(FRAME_HALO, hd)
        if t // sp < need:
            raise ValueError(f"time-shard of {t // sp} frames too small "
                             f"(needs >= {need})")
        dev = batch["mel"].device
        ddsp = model.ddsp_model
        plan = {"ddsp_noise": ((b, t * ddsp.block_size), ddsp.NOISE)}
        if family == "diffusion":
            plan.update(t=((b,), ("randint", t_max)), noise=((b, t, m_dims), "normal"))
        else:
            plan.update(t=((b,), reflow_t(t_start)), x_0=((b, t, m_dims), "normal"))
        d = global_draws(plan, draws, generator, dev)
        noise_name = "noise" if family == "diffusion" else "x_0"
        whole = dict(batch)
        if whole.get("spk_id") is None:
            whole["spk_id"] = torch.ones((b, 1), dtype=torch.long, device=dev)
        if whole.get("aug_shift") is None:
            whole["aug_shift"] = torch.zeros((b, 1, 1), device=dev)
        blk = shard_batch(world, dict(whole, ddsp_noise=d["ddsp_noise"],
                                      noise=d[noise_name]), shard_time=True)
        t_b = d["t"][batch_sharding(world, tuple(d["t"].shape))]
        tb = t // sp
        group = world.time

        audio_own = _combsub_block(ddsp, blk["units"], blk["f0"], blk["volume"],
                                   blk["ddsp_noise"], blk["spk_id"], group, t, tb,
                                   aug_shift=blk["aug_shift"])
        mel_own = _blocked_logmel(audio_own, mel, group, tb)
        gt = blk["mel"]
        ddsp_sse = torch.sum((mel_own - gt) ** 2)

        spec = norm.norm_spec(gt)
        noise_own = blk["noise"]
        if family == "diffusion":
            ti = t_b.long()
            c0 = c0_tab.to(dev)[ti][:, None, None]
            c1 = c1_tab.to(dev)[ti][:, None, None]
            x_noisy = c0 * spec + c1 * noise_own
            t_net, target = ti.to(spec.dtype), noise_own
            w = torch.ones_like(t_net)
        else:
            tf = t_b.to(spec.dtype)
            x_noisy = noise_own + tf[:, None, None] * (spec - noise_own)
            t_net, target = 1000.0 * tf, spec - noise_own
            # l2_lognorm's weight (models/reflow.py)
            w = (0.398942 / tf / (1.0 - tf)
                 * torch.exp(-0.5 * torch.log(tf / (1.0 - tf)) ** 2))

        x_ext = _frame_halo(x_noisy, hd, hd, group, 0.0)
        cond_ext = _frame_halo(mel_own, hd, hd, group, 0.0)
        kg = torch.arange(tb + 2 * hd, device=dev) + group.rank * tb - hd
        edge = ((kg >= 0) & (kg < t)).to(spec.dtype)[None, :, None]
        edge = edge.expand(x_ext.shape[0], -1, 1)
        pred = net(x_ext, t_net, cond_ext.contiguous(), edge_mask=edge)[:, hd:hd + tb]
        diff_sse = torch.sum(w[:, None, None] * (target - pred) ** 2)

        # this block's share of the global means; summed over the world
        # outside the backward (no collective on the loss)
        denom = float(b * t * m_dims)
        ddsp_l, diff_l = ddsp_sse / denom, diff_sse / denom
        loss = lambda_ddsp * ddsp_l + diff_l
        ddsp_total, diff_total = apply_update(state, loss, [ddsp_l, diff_l],
                                              world.world)
        return {"loss": lambda_ddsp * ddsp_total + diff_total,
                "ddsp_loss": ddsp_total, "diff_loss": diff_total}

    return step
