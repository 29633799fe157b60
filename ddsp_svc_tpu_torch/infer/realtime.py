"""Realtime sliding-window voice conversion with SOLA splicing (mirrors
ddsp_svc_tpu/infer/realtime.py: ``phase_vocoder``, ``RealtimeVC`` and
``drive_blocks``), the engine of the reference GUI's audio callback,
decoupled from any audio backend:

- a rolling input buffer of block + extra-context seconds;
- f0 and the enhancer skip the stale context through ``silence_front``;
- per block: ``SvcPipeline.infer`` on the whole context, the tail window
  taken, the SOLA offset found by normalised cross-correlation over a
  10 ms search range, the splice made with a squared-sine cross-fade or
  the phase vocoder, and the tail carried as the next SOLA buffer.

The splice is host numpy, as in the JAX package; the pipeline runs on its
own device, and its output is brought to the IO rate by the port's
``ops/resample.py``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.resample import resample


def phase_vocoder(a: np.ndarray, b: np.ndarray, fade_out: np.ndarray,
                  fade_in: np.ndarray) -> np.ndarray:
    """Phase-vocoder cross-fade of equal-length windows ``a`` -> ``b``."""
    n = a.shape[0]
    window = np.sqrt(fade_out * fade_in)
    fa = np.fft.rfft(a * window)
    fb = np.fft.rfft(b * window)
    absab = np.abs(fa) + np.abs(fb)
    if n % 2 == 0:
        absab[1:-1] *= 2
    else:
        absab[1:] *= 2
    phia = np.angle(fa)
    phib = np.angle(fb)
    deltaphase = phib - phia
    deltaphase -= 2 * np.pi * np.floor(deltaphase / 2 / np.pi + 0.5)
    w = 2 * np.pi * np.arange(n // 2 + 1) + deltaphase
    t = np.arange(n) / n
    return (a * (fade_out ** 2) + b * (fade_in ** 2)
            + np.sum(absab[:, None] * np.cos(w[:, None] * t[None, :] + phia[:, None]),
                     axis=0) * window / n)


class RealtimeVC:
    """One conversion per block of ``block_time`` seconds at ``sample_rate``
    over the last ``extra_time + block_time`` seconds of input. Extra
    keyword arguments go to every ``pipeline.infer`` call (``use_silence``,
    ``spk_mix_dict``, the sampler settings, ``noise``)."""

    def __init__(self, pipeline, sample_rate: int = 44100,
                 block_time: float = 0.3, crossfade_time: float = 0.04,
                 extra_time: float = 2.0, sola_search_time: float = 0.01,
                 use_phase_vocoder: bool = False, spk_id: int = 1,
                 key_shift: float = 0.0, threhold: float = -45.0,
                 **infer_kwargs):
        self.pipeline = pipeline
        self.sr = sample_rate
        self.block_frame = int(block_time * sample_rate)
        self.crossfade_frame = int(crossfade_time * sample_rate)
        self.sola_search_frame = int(sola_search_time * sample_rate)
        self.extra_frame = int(extra_time * sample_rate)
        self.use_phase_vocoder = use_phase_vocoder
        self.spk_id = spk_id
        self.key_shift = key_shift
        self.threhold = threhold
        self.infer_kwargs = infer_kwargs
        self.input_wav = np.zeros(self.extra_frame + self.block_frame,
                                  dtype=np.float32)
        # the last 20 ms of each inference is edge-contaminated (the convs'
        # right padding, the f0's edge frames) and never reaches the output
        self.last_delay_frame = int(0.02 * sample_rate)
        self.sola_buffer = np.zeros(self.crossfade_frame, dtype=np.float32)
        self.fade_in = np.sin(
            np.pi * np.arange(self.crossfade_frame) / self.crossfade_frame / 2) ** 2
        self.fade_out = 1.0 - self.fade_in
        # the f0 and the enhancer may skip the stale prefix
        self.safe_prefix_pad_length = max(
            extra_time - crossfade_time - sola_search_time - 0.02, 0.0)
        self._first = True

    def warmup(self, extra_variants: list[dict] | None = None) -> None:
        """Run one silent block per variant of the infer arguments before
        going live, so the first real block finds every kernel built and
        every allocation cached: the current arguments, for the mel
        cascades also with ``use_silence`` toggled, and ``extra_variants``
        (overrides of the infer arguments). The engine's state is kept."""
        state = (self.input_wav.copy(), self.sola_buffer.copy(), self._first)
        variants: list[dict] = [{}]
        if getattr(self.pipeline, "family", "ddsp") != "ddsp":
            cur = bool(self.infer_kwargs.get("use_silence", False))
            variants.append({"use_silence": not cur})
        variants.extend(extra_variants or [])
        saved_kwargs = dict(self.infer_kwargs)
        try:
            for var in variants:
                self.infer_kwargs = {**saved_kwargs, **var}
                self.input_wav = state[0].copy()
                self.sola_buffer = state[1].copy()
                self.process_block(np.zeros(self.block_frame, dtype=np.float32))
        finally:
            self.infer_kwargs = saved_kwargs
            self.input_wav, self.sola_buffer, self._first = state

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """One callback: ``block`` (block_frame samples in) -> as many out."""
        if len(block) != self.block_frame:
            raise ValueError(f"a block has {self.block_frame} samples, got "
                             f"{len(block)}")
        self.input_wav = np.roll(self.input_wav, -self.block_frame)
        self.input_wav[-self.block_frame:] = block

        out, out_sr = self.pipeline.infer(
            self.input_wav, self.sr, spk_id=self.spk_id,
            key_shift=self.key_shift, threhold=self.threhold,
            # 0.03 s before the pad boundary, so windowed f0 trackers keep
            # real left context at the head of the output window
            silence_front=max(self.safe_prefix_pad_length - 0.03, 0.0),
            **self.infer_kwargs)
        if out_sr != self.sr:
            out = resample(torch.as_tensor(out, device=self.pipeline.device)[None],
                           out_sr, self.sr)[0].cpu().numpy()

        # the window just before the edge-contaminated tail
        need = self.block_frame + self.crossfade_frame + self.sola_search_frame
        ld = self.last_delay_frame
        if len(out) >= need + ld:
            infer_tail = out[-(need + ld):-ld]
        else:
            tail = out[:-ld] if ld and len(out) > ld else out
            infer_tail = np.pad(tail, (max(0, need - len(tail)), 0))[-need:]

        # the SOLA offset by normalised cross-correlation
        cf = self.crossfade_frame
        if self.sola_search_frame > 0 and not self._first:
            window = infer_tail[:self.sola_search_frame + cf]
            cor_nom = np.correlate(window, self.sola_buffer, "valid")
            energy = np.convolve(window ** 2, np.ones(cf), "valid")
            sola_offset = int(np.argmax(cor_nom / np.sqrt(energy + 1e-8)))
        else:
            sola_offset = 0

        seg = infer_tail[sola_offset:sola_offset + self.block_frame].copy()
        if not self._first:
            head = infer_tail[sola_offset:sola_offset + cf]
            if self.use_phase_vocoder:
                seg[:cf] = phase_vocoder(self.sola_buffer, head, self.fade_out,
                                         self.fade_in)
            else:
                seg[:cf] = self.sola_buffer * self.fade_out + head * self.fade_in
        tail_start = sola_offset + self.block_frame
        tail = infer_tail[tail_start:tail_start + cf]
        self.sola_buffer = (np.pad(tail, (0, cf - len(tail))) if len(tail) < cf
                            else tail.copy())
        self._first = False
        return seg

    def process_stream(self, audio: np.ndarray) -> np.ndarray:
        """A whole recording through the block engine (file mode), padded
        to a block multiple -> the spliced output, len(audio) samples."""
        return drive_blocks(self, audio)[0]


def drive_blocks(vc: RealtimeVC, audio: np.ndarray) -> tuple[np.ndarray, dict]:
    """File-mode driver: pad to a block multiple and run every block, each
    timed on the host clock around ``process_block`` (which returns host
    audio, so the device's work is inside). Returns (the spliced output
    trimmed to len(audio), stats): ``block_ms`` the mean and ``rtf`` the
    real-time factor over the steady blocks (all but the first two, which
    build and allocate, when there are more), ``blocks`` and every block's
    ``times_s``."""
    n_blocks = int(np.ceil(len(audio) / vc.block_frame))
    padded = np.pad(audio, (0, n_blocks * vc.block_frame - len(audio))
                    ).astype(np.float32)
    out, times = [], []
    for i in range(n_blocks):
        t0 = time.perf_counter()
        out.append(vc.process_block(
            padded[i * vc.block_frame:(i + 1) * vc.block_frame]))
        times.append(time.perf_counter() - t0)
    steady = times[2:] or times
    block_ms = 1000.0 * float(np.mean(steady)) if steady else 0.0
    stats = {"block_ms": round(block_ms, 2),
             "rtf": (round(1000.0 * vc.block_frame / vc.sr / block_ms, 2)
                     if block_ms else None),
             "blocks": n_blocks, "times_s": times}
    return np.concatenate(out)[:len(audio)], stats
