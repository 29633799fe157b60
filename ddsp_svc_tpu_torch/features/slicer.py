"""RMS-threshold silence slicer (the port's own copy of
ddsp_svc_tpu/features/slicer.py: ``frame_rms``, ``Slicer``,
``split_audio``; host numpy).

Frame RMS (librosa.feature.rms parity: center=True, constant pad) on a
sliding window; quiet regions are the maximal runs of below-threshold
frames, and a short loop over them decides where each cut lands (the
quietest frame inside the permitted window). The returned
{idx: {"slice": bool, "split_time": "a,b"}} mapping is the JAX package's,
so the splice code of ``cli/infer.py`` carries over.
"""
from __future__ import annotations

import numpy as np


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """librosa.feature.rms parity: center-pad by frame_length//2 (constant),
    frame, sqrt(mean(x^2))."""
    pad = frame_length // 2
    yp = np.pad(y.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt((yp[idx] ** 2).mean(axis=1)).astype(np.float32)


def _quiet_runs(quiet: np.ndarray) -> list[tuple[int, int]]:
    """Maximal runs of True in a boolean array, as [start, stop) pairs."""
    fenced = np.concatenate(([False], quiet, [False])).astype(np.int8)
    edges = np.flatnonzero(np.diff(fenced))
    return list(zip(edges[::2].tolist(), edges[1::2].tolist()))


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,
        min_interval: int = 300,
        hop_size: int = 20,
        max_sil_kept: int = 5000,
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if not max_sil_kept >= hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _quietest(self, rms: np.ndarray, lo: int, hi: int) -> int:
        """Frame index of the minimum RMS within [lo, hi)."""
        return lo + int(rms[lo:hi].argmin())

    def _plan_cuts(self, rms: np.ndarray) -> list[tuple[int, int]]:
        """Turn quiet runs into removal regions [left, right] in frames.

        A region (p, p) is a pure split point (nothing removed); a leading
        region starts at 0; a trailing region's right edge is total+1 to mark
        open-endedness, matching the downstream clamp-by-sample-count.
        """
        total = rms.shape[0]
        keep = self.max_sil_kept
        cuts: list[tuple[int, int]] = []
        anchor = 0  # frame where the clip currently being accumulated began

        runs = _quiet_runs(rms < self.threshold)
        tail = None
        if runs and runs[-1][1] >= total:
            tail = runs.pop()  # unterminated by a loud frame: trailing rules

        for a, b in runs:
            # b is the first loud frame after the run; windows include it,
            # mirroring the reference's decision-at-first-loud-frame timing
            leading = a == 0 and b > keep
            interior_ok = b - a >= self.min_interval and b - anchor >= self.min_length
            if not leading and not interior_ok:
                continue
            span = b - a
            if span <= keep:
                p = self._quietest(rms, a, b + 1)
                cuts.append((0, p) if a == 0 else (p, p))
                anchor = p
            elif span <= 2 * keep:
                # windows from both edges overlap: reconcile three candidates
                mid = self._quietest(rms, b - keep, a + keep + 1)
                left = self._quietest(rms, a, a + keep + 1)
                right = self._quietest(rms, b - keep, b + 1)
                if a == 0:
                    cuts.append((0, right))
                    anchor = right
                else:
                    cuts.append((min(left, mid), max(right, mid)))
                    anchor = max(right, mid)
            else:
                left = self._quietest(rms, a, a + keep + 1)
                right = self._quietest(rms, b - keep, b + 1)
                cuts.append((0, right) if a == 0 else (left, right))
                anchor = right

        if tail is not None and total - tail[0] >= self.min_interval:
            a = tail[0]
            p = self._quietest(rms, a, min(total, a + keep) + 1)
            cuts.append((p, total + 1))
        return cuts

    def slice(self, waveform: np.ndarray) -> dict:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        n_samples = len(waveform)
        if samples.shape[0] <= self.min_length:
            return {"0": {"slice": False, "split_time": f"0,{n_samples}"}}
        rms = frame_rms(samples, self.win_size, self.hop_size)
        cuts = self._plan_cuts(rms)
        if not cuts:
            return {"0": {"slice": False, "split_time": f"0,{n_samples}"}}

        # interleave kept-audio chunks with the silence regions between them;
        # region starts stay unclamped, ends clamp to the sample count
        hop = self.hop_size
        pieces: list[tuple[bool, int, int]] = []
        prev_end = None
        for left, right in cuts:
            start = 0 if prev_end is None else prev_end * hop
            if prev_end is not None or left > 0:
                pieces.append((False, start, min(n_samples, left * hop)))
            pieces.append((True, left * hop, min(n_samples, right * hop)))
            prev_end = right
        if prev_end * hop < n_samples:
            pieces.append((False, prev_end * hop, n_samples))
        return {
            str(i): {"slice": is_sil, "split_time": f"{a},{b}"}
            for i, (is_sil, a, b) in enumerate(pieces)
        }


def split_audio(audio: np.ndarray, sr: int, db_thresh: float = -40, min_len: int = 5000):
    """Slice + materialize segments (main.py:123-139 'split' semantics).

    Returns list of (start_sample, segment) for non-silent chunks.
    """
    chunks = Slicer(sr=sr, threshold=db_thresh, min_length=min_len).slice(audio)
    result = []
    for v in chunks.values():
        tag = v["split_time"].split(",")
        if int(tag[0]) != int(tag[1]) and not v["slice"]:
            start = int(tag[0])
            result.append((start, audio[start : int(tag[1])]))
    return result
