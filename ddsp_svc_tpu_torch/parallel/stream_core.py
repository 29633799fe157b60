"""The streamed drivers' toolkit (mirrors ddsp_svc_tpu/parallel/
stream_core.py): the halo widths, the frame and sample halo exchanges, the
exact integer phase-carry prefix over the ranks, the blocked log-mel, and
the masks of a haloed block.

Each function runs on every rank of a ``mesh.TimeGroup`` with that rank's
block. JAX draws its noise per frame from split keys inside the block; the
port takes every draw as a tensor of the whole utterance on rank 0 (its
own default: one draw from a seeded ``torch.Generator``) and scatters it,
so a block sees the very samples the whole-utterance pass sees. JAX's
``_cached_jit`` has no counterpart: the port runs eagerly.
"""
from __future__ import annotations

import torch

from ..ops.spectral import frame_signal

FRAME_HALO = 48  # conv stack (2) + 3 conformer layers (15 each) + margin
DENOISER_HALO = 96  # NaiveV2Diff: 6 conv layers x (k=31)//2 = 90 + margin
WAVENET_HALO = 24  # 20 layers x k=3 d=1 -> 20 frames + margin
VOCODER_HALO = 32  # mel frames; must exceed the Generator's receptive field


def _edge(received: torch.Tensor, fill: torch.Tensor, sender: bool
          ) -> torch.Tensor:
    """The halo a neighbour sent, or ``fill`` where there is no neighbour:
    a selection by mask, so every rank builds the same graph and issues
    the same collectives in its backward."""
    keep = torch.full((), sender, dtype=torch.bool, device=received.device)
    return torch.where(keep, received, fill)


def _frame_halo(x: torch.Tensor, h_left: int, h_right: int, group,
                edge_value: float | None = 0.0) -> torch.Tensor:
    """(B, tb, ...) -> (B, h_left + tb + h_right, ...): the neighbours'
    frames on each side (frame axis 1). At the utterance's edges (rank 0's
    left, the last rank's right) the halo is ``edge_value``, or the edge
    frame replicated when ``edge_value`` is None."""
    left, right = group.exchange(x[:, -h_left:] if h_left else None,
                                 x[:, :h_right] if h_right else None)

    def fill(edge, h):
        if edge_value is None:
            return edge.expand(-1, h, *([-1] * (x.dim() - 2)))
        return torch.full((x.shape[0], h) + tuple(x.shape[2:]), edge_value,
                          dtype=x.dtype, device=x.device)

    parts = []
    if h_left:
        parts.append(_edge(left, fill(x[:, :1], h_left), group.rank > 0))
    parts.append(x)
    if h_right:
        parts.append(_edge(right, fill(x[:, -1:], h_right),
                           group.rank < group.size - 1))
    return torch.cat(parts, dim=1)


def _sample_halo_reflect(x: torch.Tensor, hs: int, group) -> torch.Tensor:
    """(B, L) -> (B, hs + L + hs): the neighbours' samples, torch's reflect
    padding at the utterance's edges (``torch.stft(center=True)``)."""
    left, right = group.exchange(x[:, -hs:], x[:, :hs])
    left = _edge(left, x[:, 1:hs + 1].flip(1), group.rank > 0)
    right = _edge(right, x[:, -hs - 1:-1].flip(1), group.rank < group.size - 1)
    return torch.cat([left, x, right], dim=1)


def _carry_prefix_offset(q_own: torch.Tensor, q_left: torch.Tensor,
                         group) -> torch.Tensor:
    """The exact phase-carry offset of a haloed block: the sum of every
    earlier rank's own quantised increments, less this block's left-halo
    increments. q_own (B, tb, 1), q_left (B, h, 1) int32 -> (B, 1, 1) int64.
    Integer sums are exact in int64 and the carry keeps their residue
    mod 2^22, so the blocked phase is the whole one bit for bit."""
    s_own = torch.sum(q_own, dim=1, keepdim=True, dtype=torch.int64)
    gathered = group.all_gather(s_own)  # (size, B, 1, 1)
    prefix = torch.sum(gathered[:group.rank], dim=0)
    return prefix - torch.sum(q_left, dim=1, keepdim=True, dtype=torch.int64)


def _blocked_logmel(audio_own: torch.Tensor, mel, group, tb: int
                    ) -> torch.Tensor:
    """Each rank's log-mel on sample-haloed audio, frame for frame the
    whole utterance's ``LogMelSpectrogram.extract`` (n_fft == win_size):
    audio (B, tb * hop) -> (B, tb, n_mels)."""
    w, h = mel.win_size, mel.hop_length
    if mel.n_fft != w:
        raise ValueError("the blocked log-mel needs n_fft == win_size")
    pad_left = (w - h) // 2
    ext = _sample_halo_reflect(audio_own, pad_left + h, group)
    frames = frame_signal(ext, w, h)[:, 1:1 + tb] * mel.window
    spec = torch.fft.rfft(frames, w, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9).transpose(1, 2)
    melspec = torch.matmul(mel.mel_basis, mag)
    return torch.log(torch.clamp(melspec, min=mel.clip_val)).transpose(1, 2)


def block_masks(group, b: int, t: int, tb: int, halo: int, dtype,
                device) -> tuple:
    """-> (edge_mask, frame_mask), each (B, tb + 2 halo, 1): 1 where the
    block's frame lies inside the utterance; 1 on the block's own frames."""
    kg = torch.arange(tb + 2 * halo, device=device) + group.rank * tb - halo
    edge = ((kg >= 0) & (kg < t)).to(dtype)[None, :, None].expand(b, -1, 1)
    own = ((kg >= group.rank * tb) & (kg < (group.rank + 1) * tb))
    own = own.to(dtype)[None, :, None].expand(b, -1, 1)
    return edge, own


def sample_mask(group, tb: int, block: int, first_frame: int, n_frames: int,
                t: int, dtype, device) -> torch.Tensor:
    """(1, n_frames * block): 1 on the samples inside the utterance, for a
    span that starts at the block's frame ``first_frame`` (relative to its
    own first frame)."""
    pos = (torch.arange(n_frames * block, device=device)
           + (group.rank * tb + first_frame) * block)
    return ((pos >= 0) & (pos < t * block)).to(dtype)[None, :]


def check_blocks(t: int, n: int, need: int) -> int:
    """JAX's asserts: T a multiple of the ranks, each block >= ``need``
    frames -> the block length."""
    if t % n:
        raise ValueError(f"frames {t} not divisible by {n} ranks")
    tb = t // n
    if tb < need:
        raise ValueError(f"block of {tb} frames too small for the halos "
                         f"(needs >= {need})")
    return tb


def default_draw(shape, kind: str, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """A whole-utterance draw on rank 0: 'normal' N(0, 1) or 'uniform'
    U(-1, 1), from ``generator`` (on ``device``)."""
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device)
    return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0


def scatter_inputs(group, need: int, units, f0, volume, spk_id=None,
                   draws: dict | None = None, draw_block: int = 1,
                   generator: torch.Generator | None = None) -> tuple:
    """The front of a DDSP driver on every rank: rank 0's (B, T) and
    ``need`` checked, the own blocks of units, f0 and volume (B, T, ...)
    (``P(None, axis)``), spk_id (B, 1) on every rank (``P()``; ones by
    default), and each draw of ``draws`` {name: (tensor or None, kind)} cut
    into blocks of ``draw_block`` samples per frame, a missing one drawn on
    rank 0 first (``default_draw``) -> (b, t, tb, units_b, f0_b, vol_b,
    spk_id, {name: block})."""
    b, t = group.broadcast_object(
        None if group.rank else (units.shape[0], units.shape[1]))
    tb = check_blocks(t, group.size, need)
    if group.rank == 0 and spk_id is None:
        spk_id = torch.ones((b, 1), dtype=torch.long, device=units.device)
    blocks = [group.scatter_blocks(x) for x in (units, f0, volume)]
    spk_id = group.broadcast(spk_id)
    out = {}
    for name, (x, kind) in (draws or {}).items():
        if group.rank == 0 and x is None:
            x = default_draw((b, t * draw_block), kind, generator,
                             units.device)
        out[name] = group.scatter_blocks(x)
    return (b, t, tb, *blocks, spk_id, out)
