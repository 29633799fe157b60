"""Frame-level RMS volume and the volume gate (the port's own copy of
ddsp_svc_tpu/features/volume.py: ``VolumeExtractor`` on the host in numpy,
``get_mask_batch`` the same gate over a batch of rows on any device)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class VolumeExtractor:
    def __init__(self, hop_size: int = 512):
        self.hop_size = hop_size

    def extract(self, audio: np.ndarray) -> np.ndarray:
        """1-D float audio -> (len // hop + 1,) RMS volume: audio^2
        reflect-padded by hop // 2, per-hop mean, sqrt."""
        hop = self.hop_size
        n_frames = int(len(audio) // hop) + 1
        audio2 = np.pad(audio.astype(np.float64) ** 2,
                        (hop // 2, (hop + 1) // 2), mode="reflect")
        blocks = audio2[: n_frames * hop].reshape(n_frames, hop)
        return np.sqrt(blocks.mean(axis=1)).astype(np.float32)

    def get_mask(self, volume: np.ndarray, threshold: float, win: int = 9
                 ) -> np.ndarray:
        """Frame gate: volume > threshold (dB), edge-padded by win // 2,
        max-dilated over ``win`` frames."""
        mask = (volume > 10 ** (threshold / 20.0)).astype(np.float32)
        pad = win // 2
        mp = np.pad(mask, (pad, pad), constant_values=(mask[0], mask[-1]))
        windows = np.lib.stride_tricks.sliding_window_view(mp, win)
        return windows.max(axis=-1)


def get_mask_batch(volume: torch.Tensor, gate: float, win: int = 9) -> torch.Tensor:
    """``VolumeExtractor.get_mask`` over a batch of rows (JAX
    ``get_mask_jnp``): ``volume`` (B, T), ``gate`` the linear threshold
    10^(dB / 20) -> (B, T) float32: the gate, each row edge-padded by
    win // 2, max-dilated over ``win`` frames."""
    m = (volume > gate).float()[:, None, :]
    m = F.pad(m, (win // 2, win // 2), mode="replicate")
    return F.max_pool1d(m, win, stride=1)[:, 0]
