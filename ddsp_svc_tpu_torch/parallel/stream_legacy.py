"""Streamed Sins and the legacy CombSub (mirrors ddsp_svc_tpu/parallel/
stream_legacy.py): the harmonic bank or the combtooth on a haloed block,
then the LTV-FIR filters as a blocked ``fft_convolve``.

Sins' harmonic bank runs through kernel K4 (``ops/cuda_oscillator.
harmonic_bank``) once per rank, on the block's exact phase.
"""
from __future__ import annotations

import math

import torch

from ..ops.cuda_oscillator import harmonic_bank
from ..ops.fir import frequency_impulse_response, get_fft_size
from ..ops.interp import upsample
from ..ops.source import cumsum_increments_q, cumsum_phase_source
from ..ops.spectral import frame_signal, overlap_add
from ..ops.window import bartlett_window
from .stream_core import (FRAME_HALO, _carry_prefix_offset, _frame_halo,
                          block_masks, sample_mask, scatter_inputs)


def _blocked_fft_convolve(audio_slice, ir_slice, kg0: int, t: int, tb: int,
                          block: int, hf2: int, out_halo: int = 0):
    """Blocked ``ops/fir.fft_convolve``: frames [kg0, kg0 + tb + 2 hf2] of
    the whole padded signal's framing.

    audio_slice (B, (tb + 2 hf2 + 2) block): samples [kg0 block - block,
    (kg0 + tb + 2 hf2) block + block), zero outside the utterance.
    ir_slice (B, tb + 2 hf2 + 1, ir): each frame's impulse response (the
    last frame's again at index T). ``out_halo`` extra output frames on
    each side (for a chained filter). -> (B, (tb + 2 out_halo) block):
    samples [(s - out_halo) block, (e + out_halo) block), zero outside."""
    ir_size = ir_slice.shape[-1]
    n_frames = tb + 2 * hf2 + 1
    fft_size = get_fft_size(2 * block, ir_size)
    frames = frame_signal(audio_slice, 2 * block, block)
    frames = frames * torch.from_numpy(bartlett_window(2 * block)).to(frames)
    out_frames = torch.fft.irfft(
        torch.fft.rfft(frames, fft_size, dim=-1)
        * torch.fft.rfft(ir_slice, fft_size, dim=-1), fft_size, dim=-1)
    kg = torch.arange(n_frames, device=frames.device) + kg0
    valid = ((kg >= 0) & (kg <= t)).to(out_frames.dtype)[None, :, None]
    y = overlap_add(out_frames * valid, block)
    start = (hf2 - out_halo) * block + block + ir_size // 2
    out = y[:, start:start + (tb + 2 * out_halo) * block]
    if out_halo:
        pos = (torch.arange(out.shape[1], device=out.device)
               + (kg0 + hf2 - out_halo) * block)
        out = out * ((pos >= 0) & (pos < t * block)).to(out.dtype)[None, :]
    return out


def _haloed_phase(model, units_b, f0_b, vol_b, group, tb: int):
    """-> (f0_ext, units_ext, vol_ext, f0_up_ext, x_ext): FRAME_HALO-haloed
    frames and the block's exact wrapped phase in cycles."""
    hf = FRAME_HALO
    block, sr = model.block_size, model.sampling_rate
    f0_ext = _frame_halo(f0_b, hf, hf, group, edge_value=None)
    units_ext = _frame_halo(units_b, hf, hf, group, edge_value=0.0)
    vol_ext = _frame_halo(vol_b, hf, hf, group, edge_value=0.0)
    f0_up_ext = upsample(f0_ext, block)
    q_ext = cumsum_increments_q(f0_up_ext, sr, block)
    offset = _carry_prefix_offset(q_ext[:, hf:hf + tb], q_ext[:, :hf], group)
    x_ext = cumsum_phase_source(f0_up_ext, sr, block, carry_offset_q=offset)
    return f0_ext, units_ext, vol_ext, f0_up_ext, x_ext


def _fix_tail(a, kg, t: int):
    """Beyond the utterance's end the whole path repeats the last frame
    (the upsampler's edge and the duplicated IR frame)."""
    last = torch.sum(a * (kg == t - 1).to(a.dtype)[None, :, None], dim=1,
                     keepdim=True)
    return torch.where((kg >= t - 1)[None, :, None], last, a)


def _haloed_noise(noise_b, group, b: int, tb: int, block: int, smask):
    hf = FRAME_HALO
    noise = _frame_halo(noise_b.reshape(b, tb, block), hf, hf, group, 0.0)
    return noise.reshape(b, (tb + 2 * hf) * block) * smask


def _filter_halos(block: int, *ir_sizes: int) -> list:
    return [get_fft_size(2 * block, ir) // block + 2 for ir in ir_sizes]


@torch.no_grad()
def streamed_sins_forward(model, units, f0, volume, group, noise=None,
                          spk_id=None, generator=None):
    """Time-sharded Sins over ``group``'s ranks (rank 0 passes the whole
    arrays and optionally the U(-1, 1) ``noise`` (B, T * block); the others
    None) -> (B, T * block) on rank 0: ``model(..., noise=)``'s audio."""
    block, hf = model.block_size, FRAME_HALO
    ir_h = 2 * (model.unit2ctrl.output_splits["group_delay"] - 1)
    ir_n = 2 * (model.unit2ctrl.output_splits["noise_magnitude"] - 1)
    hf2_h, hf2_n = _filter_halos(block, ir_h, ir_n)
    if hf < max(hf2_h, hf2_n) + 1:
        raise ValueError(f"FRAME_HALO {hf} below the filters' halos "
                         f"{max(hf2_h, hf2_n) + 1}")
    b, t, tb, units_b, f0_b, vol_b, spk_id, draws = scatter_inputs(
        group, hf, units, f0, volume, spk_id, {"noise": (noise, "uniform")},
        block, generator)
    d, dev = group.rank, f0_b.device
    ext_t = tb + 2 * hf
    f0_ext, units_ext, vol_ext, _, x_ext = _haloed_phase(
        model, units_b, f0_b, vol_b, group, tb)
    kg = torch.arange(ext_t, device=dev) + d * tb - hf
    edge, own = block_masks(group, b, t, tb, hf, units_b.dtype, dev)
    amps, gd, nmag, _ = model.controls(
        units_ext, f0_ext, 2.0 * math.pi * x_ext[:, ::block, :], vol_ext,
        spk_id=spk_id, frame_mask=own, group=group, edge_mask=edge)
    amps, gd, nmag = (_fix_tail(a, kg, t) for a in (amps, gd, nmag))

    smask = sample_mask(group, tb, block, -hf, ext_t, t, f0_b.dtype, dev)
    sin_ext = harmonic_bank(x_ext.contiguous(), amps.contiguous(), block) * smask
    noise_ext = _haloed_noise(draws["noise"], group, b, tb, block, smask)
    ir_harm = frequency_impulse_response(
        torch.polar(torch.ones_like(gd), torch.cumsum(gd, dim=-1)),
        hann_window_flag=False)
    ir_noise = frequency_impulse_response(nmag.to(torch.complex64),
                                          hann_window_flag=True)

    def run(sig_ext, ir_ext, hf2):
        a0, a1 = (hf - hf2 - 1) * block, (hf + tb + hf2 + 1) * block
        return _blocked_fft_convolve(sig_ext[:, a0:a1],
                                     ir_ext[:, hf - hf2:hf + tb + hf2 + 1],
                                     d * tb - hf2, t, tb, block, hf2)

    out = run(sin_ext, ir_harm, hf2_h) + run(noise_ext, ir_noise, hf2_n)
    return group.gather_blocks(out)


@torch.no_grad()
def streamed_combsub_old_forward(model, units, f0, volume, group, noise=None,
                                 spk_id=None, generator=None):
    """Time-sharded legacy CombSub: the combtooth through the all-pass
    group-delay filter, then the dynamically windowed source filter (a
    chained blocked LTV-FIR), plus the filtered noise; as
    ``streamed_sins_forward`` otherwise."""
    block, hf = model.block_size, FRAME_HALO
    splits = model.unit2ctrl.output_splits
    ir1 = 2 * (splits["group_delay"] - 1)
    ir2 = 2 * (splits["harmonic_magnitude"] - 1)
    ir3 = 2 * (splits["noise_magnitude"] - 1)
    (hf2_2,) = _filter_halos(block, ir2)
    out_halo1 = hf2_2 + 1
    hf2_1 = _filter_halos(block, ir1)[0] + out_halo1
    (hf2_3,) = _filter_halos(block, ir3)
    if hf < max(hf2_1, hf2_3) + 1:
        raise ValueError(f"FRAME_HALO {hf} below the filters' halos "
                         f"{max(hf2_1, hf2_3) + 1}")
    b, t, tb, units_b, f0_b, vol_b, spk_id, draws = scatter_inputs(
        group, hf, units, f0, volume, spk_id, {"noise": (noise, "uniform")},
        block, generator)
    d, dev, sr = group.rank, f0_b.device, model.sampling_rate
    ext_t = tb + 2 * hf
    f0_ext, units_ext, vol_ext, f0_up_ext, x_ext = _haloed_phase(
        model, units_b, f0_b, vol_b, group, tb)
    kg = torch.arange(ext_t, device=dev) + d * tb - hf
    edge, own = block_masks(group, b, t, tb, hf, units_b.dtype, dev)
    gd, src_param, noise_param, _ = model.controls(
        units_ext, f0_ext, 2.0 * math.pi * x_ext[:, ::block, :], vol_ext,
        spk_id=spk_id, frame_mask=own, group=group, edge_mask=edge)
    gd, src_param, noise_param = (_fix_tail(a, kg, t)
                                  for a in (gd, src_param, noise_param))
    half_width = _fix_tail(1.5 * sr / (f0_ext + 1e-3), kg, t)

    smask = sample_mask(group, tb, block, -hf, ext_t, t, f0_b.dtype, dev)
    comb_ext = torch.sinc(sr * x_ext / (f0_up_ext + 1e-3))[..., 0] * smask
    ir_ap = frequency_impulse_response(
        torch.polar(torch.ones_like(gd), torch.cumsum(gd, dim=-1)),
        hann_window_flag=False)
    ir_src = frequency_impulse_response(src_param.to(torch.complex64),
                                        hann_window_flag=True,
                                        half_width_frames=half_width)
    ir_noise = frequency_impulse_response(noise_param.to(torch.complex64),
                                          hann_window_flag=True)

    def run(sig_ext, sig_off, ir_ext, hf2, out_halo=0):
        # sig_ext starts at sample (d tb - sig_off) block
        lo = (sig_off - hf2 - 1) * block
        hi = lo + (tb + 2 * hf2 + 2) * block
        return _blocked_fft_convolve(sig_ext[:, lo:hi],
                                     ir_ext[:, hf - hf2:hf + tb + hf2 + 1],
                                     d * tb - hf2, t, tb, block, hf2, out_halo)

    harmonic = run(run(comb_ext, hf, ir_ap, hf2_1, out_halo1), out_halo1,
                   ir_src, hf2_2)
    noise_ext = _haloed_noise(draws["noise"], group, b, tb, block, smask)
    return group.gather_blocks(harmonic + run(noise_ext, hf, ir_noise, hf2_3))
