"""Streamed CombSubSuperFast and CombSubFast (mirrors ddsp_svc_tpu/parallel/
stream_combsub.py): each rank synthesises its block of frames from its
haloed inputs; the results join on rank 0.

CombSubSuperFast's exciter runs through kernel K1 (``ops/cuda_source.
combtooth``) once per rank, with the rank's exact carry prefix as its
``carry_offset_q``.
"""
from __future__ import annotations

import math

import torch

from ..ops.cuda_source import combtooth
from ..ops.interp import upsample
from ..ops.source import (cumsum_increments_q, cumsum_phase_source,
                          frame_phase_increments_q)
from ..ops.spectral import frame_signal, overlap_add
from ..ops.window import hann_window, sqrt_hann_window
from .stream_core import (FRAME_HALO, _carry_prefix_offset, _frame_halo,
                          _sample_halo_reflect, block_masks, sample_mask,
                          scatter_inputs)


def _haloed_controls(units_b, f0_b, vol_b, group):
    hf = FRAME_HALO
    return (_frame_halo(f0_b, hf, hf, group, edge_value=None),
            _frame_halo(units_b, hf, hf, group, edge_value=0.0),
            _frame_halo(vol_b, hf, hf, group, edge_value=0.0))


def _combsub_block(model, units_b, f0_b, vol_b, noise_b, spk_id, group,
                   t: int, tb: int, aug_shift=None) -> torch.Tensor:
    """One rank's CombSubSuperFast synthesis: own blocks of units, f0,
    volume (B, tb, ...) and noise (B, tb * hop) -> own audio (B, tb * hop).
    Also the DDSP stage of the streamed cascades."""
    hop, win = model.block_size, model.win_length
    hf = FRAME_HALO
    hs = 3 * hop + win // 2
    b = units_b.shape[0]
    dev = f0_b.device
    window = torch.from_numpy(hann_window(win)).to(dev)

    f0_ext, units_ext, vol_ext = _haloed_controls(units_b, f0_b, vol_b, group)
    q_ext = frame_phase_increments_q(f0_ext, model.sampling_rate, hop)
    offset = _carry_prefix_offset(q_ext[:, hf:hf + tb], q_ext[:, :hf], group)
    comb_ext, phase_ext = combtooth(f0_ext.contiguous(), model.sampling_rate,
                                    hop, carry_offset_q=offset.contiguous())

    edge, own = block_masks(group, b, t, tb, hf, units_b.dtype, dev)
    src_ext, nf_ext, _ = model.controls(
        units_ext, f0_ext, phase_ext, vol_ext, spk_id=spk_id,
        aug_shift=aug_shift, frame_mask=own, group=group, edge_mask=edge)
    # filters for stft frames [s - 3, e + 3]; frame T takes the last
    # frame's filter again, as the whole path duplicates it
    src_fr = _frame_halo(src_ext[:, hf:hf + tb], 3, 4, group, edge_value=None)
    nf_fr = _frame_halo(nf_ext[:, hf:hf + tb], 3, 4, group, edge_value=None)

    comb_sh = _sample_halo_reflect(comb_ext[:, hf * hop:(hf + tb) * hop], hs,
                                   group)
    noise_sh = _sample_halo_reflect(noise_b, hs, group)
    s_comb = torch.fft.rfft(frame_signal(comb_sh, win, hop) * window, win, dim=-1)
    s_noise = torch.fft.rfft(frame_signal(noise_sh, win, hop) * window, win,
                             dim=-1)
    y_frames = torch.fft.irfft(s_comb * src_fr + s_noise * nf_fr, win,
                               dim=-1) * window
    fg = torch.arange(tb + 7, device=dev) + group.rank * tb - 3
    valid = ((fg >= 0) & (fg <= t)).to(y_frames.dtype)[None, :, None]
    y = overlap_add(y_frames * valid, hop)
    wsq = (window * window)[None, None, :].expand(1, tb + 7, win) * valid
    y = y / torch.clamp(overlap_add(wsq.contiguous(), hop), min=1e-11)
    return y[:, hs:hs + tb * hop]


@torch.no_grad()
def streamed_combsub_forward(model, units, f0, volume, group, noise=None,
                             spk_id=None, generator=None):
    """Time-sharded CombSubSuperFast over ``group``'s ranks; every rank
    calls it, rank 0 with the whole units (B, T, n_unit), f0 and volume
    (B, T, 1) and optionally the N(0, 1) ``noise`` (B, T * hop), the others
    with None. -> (B, T * hop) audio on rank 0 (None elsewhere), the
    whole-utterance forward's with that noise (``model(units, f0, volume,
    noise=noise)[0]``)."""
    hop, win = model.block_size, model.win_length
    need = max(FRAME_HALO, 4, -(-(3 * hop + win // 2) // hop))
    b, t, tb, units_b, f0_b, vol_b, spk_id, draws = scatter_inputs(
        group, need, units, f0, volume, spk_id, {"noise": (noise, "normal")},
        hop, generator)
    audio_b = _combsub_block(model, units_b, f0_b, vol_b, draws["noise"],
                             spk_id, group, t, tb)
    return group.gather_blocks(audio_b)


def _combsubfast_block(model, units_b, f0_b, vol_b, noise_b, spk_id, group,
                       t: int, tb: int) -> tuple:
    """One rank's CombSubFast synthesis: own blocks and U(-1, 1) noise
    (B, tb * block) -> (own audio (B, tb * block), own hidden (B, tb, 256)).
    PCmer's attention sums its k/v statistics over the group instead of
    taking a halo; the conformer convs take FRAME_HALO frames."""
    block = model.block_size
    hf = FRAME_HALO
    b = units_b.shape[0]
    dev = f0_b.device
    sr = model.sampling_rate

    f0_ext, units_ext, vol_ext = _haloed_controls(units_b, f0_b, vol_b, group)
    f0_up_ext = upsample(f0_ext, block)
    q_ext = cumsum_increments_q(f0_up_ext, sr, block)
    offset = _carry_prefix_offset(q_ext[:, hf:hf + tb], q_ext[:, :hf], group)
    x_ext = cumsum_phase_source(f0_up_ext, sr, block, carry_offset_q=offset)
    phase_ext = 2.0 * math.pi * x_ext[:, ::block, :]

    edge, own = block_masks(group, b, t, tb, hf, units_b.dtype, dev)
    src_ext, nf_ext, hidden_ext = model.controls(
        units_ext, f0_ext, phase_ext, vol_ext, spk_id=spk_id,
        frame_mask=own, group=group, edge_mask=edge)
    # filters for synthesis frames [s, e] (the last duplicated at the end)
    src_fr = _frame_halo(src_ext[:, hf:hf + tb], 0, 1, group, edge_value=None)
    nf_fr = _frame_halo(nf_ext[:, hf:hf + tb], 0, 1, group, edge_value=None)

    # sources for samples [s B - B, e B + B), zero outside the utterance
    # (the whole path pads one block of zeros on each side)
    smask = sample_mask(group, tb, block, -1, tb + 2, t, f0_b.dtype, dev)
    comb = torch.sinc(sr * x_ext / (f0_up_ext + 1e-3))[..., 0]
    comb = comb[:, (hf - 1) * block:(hf + tb + 1) * block] * smask
    noise = _frame_halo(noise_b.reshape(b, tb, block), 1, 1, group, 0.0)
    noise = noise.reshape(b, (tb + 2) * block) * smask

    window = torch.from_numpy(sqrt_hann_window(2 * block)).to(dev)

    def filtered(sig, filt):
        frames = frame_signal(sig, 2 * block, block) * window
        spec = torch.fft.rfft(frames, 2 * block, dim=-1)
        return torch.fft.irfft(spec * filt, 2 * block, dim=-1) * window

    y = overlap_add(filtered(comb, src_fr)
                    + filtered(noise, nf_fr.to(torch.complex64)), block)
    return y[:, block:block + tb * block], hidden_ext[:, hf:hf + tb]


@torch.no_grad()
def streamed_combsub_fast_forward(model, units, f0, volume, group, noise=None,
                                  spk_id=None, generator=None):
    """Time-sharded CombSubFast, as ``streamed_combsub_forward`` with the
    U(-1, 1) ``noise`` (B, T * block) of ``model(..., noise=)``."""
    block = model.block_size
    b, t, tb, units_b, f0_b, vol_b, spk_id, draws = scatter_inputs(
        group, max(FRAME_HALO, 4), units, f0, volume, spk_id,
        {"noise": (noise, "uniform")}, block, generator)
    audio_b, _ = _combsubfast_block(model, units_b, f0_b, vol_b,
                                    draws["noise"], spk_id, group, t, tb)
    return group.gather_blocks(audio_b)
