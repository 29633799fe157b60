"""Streamed NSF-HiFiGAN (mirrors ddsp_svc_tpu/parallel/stream_vocoder.py):
each rank runs the generator on its block of mel frames with VOCODER_HALO
real neighbour frames on each side, so its own samples are the padded
whole utterance's. The sine source carries its phase across the ranks by
the exact integer prefix (``sine_kwargs``' ``carry_offset_q``), and its
noise is the rank's slice of the whole draw.

Each rank's generator runs every upsampling stage's ResBlock1 group
through kernel K2 (``ops/cuda_resblock.resblock_group``): five launches a
rank for the default vocoder.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.source import sine_increments_q
from .stream_core import (VOCODER_HALO, _carry_prefix_offset, _frame_halo,
                          check_blocks)

SINE_DIM = 9  # 8 harmonics + the fundamental (m_source harmonic_num 8)


def vocoder_draws(b: int, t: int, upp: int, halo: int,
                  generator: torch.Generator | None, device) -> tuple:
    """The padded utterance's sine-source draws: (noise (B, (T + 2 halo)
    upp, 9) N(0, 1), rand_ini (1, 1, 9) U(0, 1) with the fundamental's 0)."""
    rand_ini = torch.rand((1, 1, SINE_DIM), generator=generator, device=device)
    rand_ini[..., 0] = 0.0
    noise = torch.randn((b, (t + 2 * halo) * upp, SINE_DIM),
                        generator=generator, device=device)
    return noise, rand_ini


@torch.no_grad()
def nsf_hifigan_padded_forward(gen, mel, f0, noise=None, rand_ini=None,
                               generator=None, halo: int = VOCODER_HALO):
    """The streamed vocoder's whole-utterance reference: the generator on
    mel (B, T, M) and f0 (B, T) with ``halo`` frames of silence (zero mel,
    zero f0) on each side, cropped after. ``noise`` and ``rand_ini`` as
    ``vocoder_draws`` gives them (drawn from ``generator`` when missing)."""
    b, t, _ = mel.shape
    if noise is None or rand_ini is None:
        noise, rand_ini = vocoder_draws(b, t, gen.upp, halo, generator,
                                        mel.device)
    audio = gen(F.pad(mel, (0, 0, halo, halo)), F.pad(f0, (halo, halo)),
                sine_kwargs=dict(rand_ini=rand_ini, noise=noise))
    return audio[:, halo * gen.upp:(halo + t) * gen.upp]


@torch.no_grad()
def streamed_nsf_hifigan(gen, mel, f0, group, noise=None, rand_ini=None,
                         generator=None, halo: int = VOCODER_HALO):
    """Time-sharded NSF-HiFiGAN over ``group``'s ranks: rank 0 passes mel
    (B, T, M), f0 (B, T) and optionally the draws, the others None. ->
    (B, T * upp) on rank 0, ``nsf_hifigan_padded_forward``'s audio."""
    upp = gen.upp
    b, t = group.broadcast_object(
        None if group.rank else (mel.shape[0], mel.shape[1]))
    tb = check_blocks(t, group.size, halo)
    if group.rank == 0 and (noise is None or rand_ini is None):
        noise, rand_ini = vocoder_draws(b, t, upp, halo, generator, mel.device)
    mel_b = group.scatter_blocks(mel)
    f0_b = group.scatter_blocks(f0)
    rand_ini = group.broadcast(rand_ini)
    # rank r's slice of the padded frames [r tb, r tb + tb + 2 halo)
    noise_b = group.scatter(
        None if group.rank else
        [noise[:, r * tb * upp:(r * tb + tb + 2 * halo) * upp]
         for r in range(group.size)])

    mel_ext = _frame_halo(mel_b, halo, halo, group, edge_value=0.0)
    f0_ext = _frame_halo(f0_b[..., None], halo, halo, group,
                         edge_value=0.0)[..., 0]
    sr = gen.m_source.sampling_rate
    offset = _carry_prefix_offset(sine_increments_q(f0_b, upp, sr),
                                  sine_increments_q(f0_ext, upp, sr)[:, :halo],
                                  group)
    audio = gen(mel_ext, f0_ext, sine_kwargs=dict(
        rand_ini=rand_ini, noise=noise_b, carry_offset_q=offset))
    return group.gather_blocks(audio[:, halo * upp:(halo + tb) * upp])
