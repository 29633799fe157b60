"""Streamed mel cascades (mirrors ddsp_svc_tpu/parallel/stream_cascade.py):
the DDSP stage on each rank's block, the blocked log-mel, then every
denoiser (or velocity) call of the sampler on the block with the evolving
x's halo exchanged, so the conv-only denoiser computes the whole
utterance's values on its own frames. The initial noise is the rank's
block of the whole draw and the sampler's updates are elementwise, so the
streamed mel is the whole one up to float summation order.

DiffusionFast and RectifiedFlow run CombSubSuperFast (kernel K1, once per
rank) and their NaiveV2Diff with an ``edge_mask``, which takes JAX's stock
chain rather than kernel K3 (models/naive_v2_diff.py). The full ancestral
DDPM chain (``infer_speedup`` 1) draws fresh noise at every step and is
refused, as JAX refuses it.
"""
from __future__ import annotations

import torch

from .stream_combsub import _combsub_block, _combsubfast_block
from .stream_core import (DENOISER_HALO, FRAME_HALO, WAVENET_HALO,
                          _blocked_logmel, _frame_halo, block_masks,
                          default_draw, scatter_inputs)

_CHAIN_REFUSED = ("streamed diffusion requires infer_speedup >= 2: the full "
                  "ancestral chain draws fresh noise per step, which is not "
                  "blocking-invariant (the accelerated samplers are ODE-like "
                  "given the per-frame init noise); run whole-utterance for "
                  "speedup 1")


def _check_mel(mel, model) -> None:
    if mel.hop_length != model.ddsp_model.block_size or \
            mel.sr != model.ddsp_model.sampling_rate:
        raise ValueError("the log-mel's hop and rate must be the model's")


def _haloed_net(net, cond_b, group, b: int, t: int, tb: int, halo: int):
    """-> fn(x (B, tb, M), t) -> net on x's block with ``halo`` exchanged
    frames each side, the condition's halo taken once, own frames out."""
    edge, _ = block_masks(group, b, t, tb, halo, cond_b.dtype, cond_b.device)
    cond_ext = _frame_halo(cond_b, halo, halo, group, edge_value=0.0)

    def fn(x, tv):
        x_ext = _frame_halo(x, halo, halo, group, edge_value=0.0)
        return net(x_ext, tv, cond_ext, edge_mask=edge)[:, halo:halo + tb]

    return fn


def _cascade_front(model, units, f0, volume, group, halo, ddsp_noise, kind,
                   init_noise, spk_id, generator):
    """Scatter the inputs and draws of a cascade -> (b, t, tb, blocks...,
    spk_id, ddsp noise block, init noise block)."""
    hop = model.ddsp_model.block_size
    b, t, tb, units_b, f0_b, vol_b, spk_id, draws = scatter_inputs(
        group, max(FRAME_HALO, halo), units, f0, volume, spk_id,
        {"ddsp": (ddsp_noise, kind)}, hop, generator)
    out_dims = group.broadcast_object(
        None if group.rank else model_out_dims(model))
    if group.rank == 0 and init_noise is None:
        init_noise = default_draw((b, t, out_dims), "normal", generator,
                                  units.device)
    return (b, t, tb, units_b, f0_b, vol_b, spk_id, draws["ddsp"],
            group.scatter_blocks(init_noise))


def model_out_dims(model) -> int:
    decoder = getattr(model, "diff_model", None) or getattr(
        model, "reflow_model", None) or model.decoder
    return decoder.out_dims


@torch.no_grad()
def streamed_cascade_mel(model, units, f0, volume, group, mel,
                         infer_step: int = 10, sampler: str | None = None,
                         t_start: float = 0.7, k_step: int = 100,
                         infer_speedup: int = 10, ddsp_noise=None,
                         init_noise=None, spk_id=None, generator=None):
    """Time-sharded DiffusionFast (``Unit2WavFast``) or RectifiedFlow
    (``ReflowUnit2Wav``) to the refined mel, over ``group``'s ranks: rank 0
    passes the whole units (B, T, n_unit), f0 and volume (B, T, 1) and
    optionally the DDSP stage's N(0, 1) ``ddsp_noise`` (B, T * hop) and the
    sampler's ``init_noise`` (B, T, M); the others None. ``mel`` is the
    vocoder's ``LogMelSpectrogram`` (hop = the model's block). -> (B, T, M)
    on rank 0: ``whole_cascade_reference``'s mel."""
    from ..models.cascade import ReflowUnit2Wav

    reflow = isinstance(model, ReflowUnit2Wav)
    if not reflow and infer_speedup <= 1:
        raise NotImplementedError(_CHAIN_REFUSED)
    _check_mel(mel, model)
    hd = DENOISER_HALO
    (b, t, tb, units_b, f0_b, vol_b, spk_id, ddsp_b,
     init_b) = _cascade_front(model, units, f0, volume, group, hd,
                              ddsp_noise, "normal", init_noise, spk_id,
                              generator)
    audio_b = _combsub_block(model.ddsp_model, units_b, f0_b, vol_b, ddsp_b,
                             spk_id, group, t, tb)
    mel_b = _blocked_logmel(audio_b, mel, group, tb)
    if reflow:
        fn = _haloed_net(model.velocity_fn, mel_b, group, b, t, tb, hd)
        out = model.reflow_model.infer(fn, mel_b, infer_step,
                                       sampler or "euler", t_start,
                                       init_noise=init_b)
    else:
        fn = _haloed_net(model.denoise_fn, mel_b, group, b, t, tb, hd)
        out = model.diff_model.infer(fn, mel_b, k_step, infer_speedup,
                                     sampler or "dpm-solver",
                                     init_noise=init_b)
    return group.gather_blocks(out)


@torch.no_grad()
def whole_cascade_reference(model, units, f0, volume, mel, ddsp_noise=None,
                            init_noise=None, spk_id=None, generator=None,
                            **kwargs):
    """The whole-utterance cascade (DiffusionFast, RectifiedFlow or
    DiffusionNew) with the streamed drivers' draws: ``ddsp_noise``
    (B, T * hop; N(0, 1), U(-1, 1) for DiffusionNew) and ``init_noise``
    (B, T, M), drawn from ``generator`` in the streamed default's order
    when missing. ``kwargs``: the model's sampler options."""
    from ..models.cascade import Unit2Wav

    b, t, _ = units.shape
    if ddsp_noise is None:
        ddsp_noise = default_draw(
            (b, t * model.ddsp_model.block_size),
            "uniform" if isinstance(model, Unit2Wav) else "normal",
            generator, units.device)
    if init_noise is None:
        init_noise = default_draw((b, t, model_out_dims(model)), "normal",
                                  generator, units.device)
    if spk_id is None:
        spk_id = torch.ones((b, 1), dtype=torch.long, device=units.device)
    return model(units, f0, volume, mel_extract_fn=mel.extract, spk_id=spk_id,
                 ddsp_noise=ddsp_noise, init_noise=init_noise, **kwargs)


@torch.no_grad()
def streamed_unit2wav_new_mel(model, units, f0, volume, group, mel,
                              k_step: int = 100, infer_speedup: int = 10,
                              sampler: str = "dpm-solver", ddsp_noise=None,
                              init_noise=None, spk_id=None, generator=None):
    """Time-sharded DiffusionNew (``Unit2Wav``): CombSubFast -> its blocked
    log-mel; the WaveNet diffusion conditioned on the synth's hidden, with
    WAVENET_HALO frames exchanged at every denoiser call. ``ddsp_noise`` is
    U(-1, 1); otherwise as ``streamed_cascade_mel``."""
    if infer_speedup <= 1:
        raise NotImplementedError(_CHAIN_REFUSED)
    _check_mel(mel, model)
    hd = WAVENET_HALO
    (b, t, tb, units_b, f0_b, vol_b, spk_id, ddsp_b,
     init_b) = _cascade_front(model, units, f0, volume, group, hd,
                              ddsp_noise, "uniform", init_noise, spk_id,
                              generator)
    audio_b, hidden_b = _combsubfast_block(model.ddsp_model, units_b, f0_b,
                                           vol_b, ddsp_b, spk_id, group, t,
                                           tb)
    mel_b = _blocked_logmel(audio_b, mel, group, tb)
    fn = _haloed_net(model.denoise_fn, hidden_b, group, b, t, tb, hd)
    out = model.diff_model.infer(fn, mel_b, k_step, infer_speedup, sampler,
                                 init_noise=init_b)
    return group.gather_blocks(out)


@torch.no_grad()
def streamed_unit2mel(model, units, f0, volume, group, gt_spec=None,
                      k_step: int = 100, infer_speedup: int = 10,
                      sampler: str = "dpm-solver", init_noise=None,
                      spk_id=None, generator=None):
    """Time-sharded Diffusion (``Unit2Mel``): its condition is per frame,
    so each rank embeds its own frames; only the WaveNet takes halos.
    ``gt_spec`` (B, T, M) starts the sampler shallow at ``k_step``; without
    it the sampler starts from the noise at the model's k_step_max.
    -> (B, T, M) on rank 0: ``model(..., gt_spec=, init_noise=)``'s mel."""
    if infer_speedup <= 1:
        raise NotImplementedError(_CHAIN_REFUSED)
    hd = WAVENET_HALO
    b, t, tb, units_b, f0_b, vol_b, spk_id, _ = scatter_inputs(
        group, hd, units, f0, volume, spk_id)
    out_dims = model.decoder.out_dims
    if group.rank == 0 and init_noise is None:
        init_noise = default_draw((b, t, out_dims), "normal", generator,
                                  units.device)
    init_b = group.scatter_blocks(init_noise)
    shallow = group.broadcast_object(None if group.rank else gt_spec is not None)
    gt_b = group.scatter_blocks(gt_spec) if shallow else None
    cond = model.hidden(units_b, f0_b, vol_b, spk_id)
    fn = _haloed_net(model.denoise_fn, cond, group, b, t, tb, hd)
    out = model.decoder.infer(fn, gt_b, k_step, infer_speedup, sampler,
                              init_noise=init_b, condition=cond)
    return group.gather_blocks(out)
