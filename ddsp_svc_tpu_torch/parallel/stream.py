"""Time-sharded synthesis over a ``torch.distributed`` world (mirrors
ddsp_svc_tpu/parallel/stream.py): the utterance's frames are cut into one
block per rank, every boundary quantity is exchanged explicitly, and the
streamed output is the whole utterance's:

  - frame halos (FRAME_HALO 48) for Unit2Control's conv stack and conv
    decoder, with ``edge_mask`` zeroing the frames outside the utterance
    (the whole pass's zero padding);
  - GroupNorm statistics and PCmer's FAVOR+ sums added over the ranks;
  - phase carries as int32-quantised increments whose prefix over the
    ranks is exact integer arithmetic, so the blocked phases are the whole
    ones bit for bit (``stream_core._carry_prefix_offset``);
  - sample halos (3 hop + win / 2) for the STFT / iSTFT overlap-add, with
    the global reflect padding at the edge ranks;
  - every random draw made once for the whole utterance on rank 0 and
    scattered, so each rank uses the very samples the whole pass uses.

Every entry point is collective: each rank of the group calls it, rank 0
with the whole arrays and the others with None (``mesh.World.call`` does
that for the helper ranks), and rank 0 gets the whole output. The
contract: the streamed output is the whole-utterance reference's up to
float summation order (``tests/test_torch_stream.py``).
"""
from __future__ import annotations

from .stream_cascade import (streamed_cascade_mel, streamed_unit2mel,  # noqa: F401
                             streamed_unit2wav_new_mel,
                             whole_cascade_reference)
from .stream_combsub import (streamed_combsub_fast_forward,  # noqa: F401
                             streamed_combsub_forward)
from .stream_core import (DENOISER_HALO, FRAME_HALO, VOCODER_HALO,  # noqa: F401
                          WAVENET_HALO)
from .stream_legacy import (streamed_combsub_old_forward,  # noqa: F401
                            streamed_sins_forward)
from .stream_vocoder import (nsf_hifigan_padded_forward,  # noqa: F401
                             streamed_nsf_hifigan)


def streamed_forward(model, units, f0, volume, group=None, mel=None,
                     **kwargs):
    """Dispatch time-sharded synthesis by model class, in JAX's order. The
    DDSP synths return audio; the cascades return the refined mel (pass the
    vocoder's log-mel as ``mel``); ``streamed_nsf_hifigan`` makes audio of
    it. Collective over ``group`` (see the module docstring)."""
    from ..models.cascade import ReflowUnit2Wav, Unit2Mel, Unit2Wav, Unit2WavFast
    from ..models.ddsp import CombSub, CombSubFast, CombSubSuperFast, Sins

    args = (model, units, f0, volume)
    if isinstance(model, CombSubSuperFast):
        return streamed_combsub_forward(*args, group=group, **kwargs)
    if isinstance(model, Sins):
        return streamed_sins_forward(*args, group=group, **kwargs)
    if isinstance(model, CombSub):
        return streamed_combsub_old_forward(*args, group=group, **kwargs)
    if isinstance(model, CombSubFast):
        return streamed_combsub_fast_forward(*args, group=group, **kwargs)
    if isinstance(model, (Unit2WavFast, ReflowUnit2Wav)):
        return streamed_cascade_mel(*args, group=group, mel=mel, **kwargs)
    if isinstance(model, Unit2Wav):
        return streamed_unit2wav_new_mel(*args, group=group, mel=mel, **kwargs)
    if isinstance(model, Unit2Mel):
        return streamed_unit2mel(*args, group=group, **kwargs)
    raise NotImplementedError(type(model).__name__)
