"""NSF-HiFiGAN vocoder wrapper (mirrors ddsp_svc_tpu/models/vocoder.py:
``DEFAULT_NSF_CONFIG``, ``Vocoder.extract``, ``Vocoder.infer``) for the
'nsf-hifigan' type at the vocoder's own sample rate."""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.mel import LogMelSpectrogram
from .nsf_hifigan import Generator

DEFAULT_NSF_CONFIG = dict(
    sampling_rate=44100,
    num_mels=128,
    n_fft=2048,
    win_size=2048,
    hop_size=512,
    fmin=40,
    fmax=16000,
    upsample_rates=(8, 8, 2, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4, 4),
    upsample_initial_channel=512,
    resblock="1",
    resblock_kernel_sizes=(3, 7, 11),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
)


class Vocoder(nn.Module):
    def __init__(self, vocoder_type: str = "nsf-hifigan",
                 config: dict | None = None):
        super().__init__()
        if vocoder_type != "nsf-hifigan":
            raise NotImplementedError(
                f"vocoder type {vocoder_type!r}: only 'nsf-hifigan' is ported")
        cfg = dict(DEFAULT_NSF_CONFIG)
        cfg.update(config or {})
        self.config = cfg
        self.vocoder_sample_rate = cfg["sampling_rate"]
        self.vocoder_hop_size = cfg["hop_size"]
        self.dimension = cfg["num_mels"]
        self.mel = LogMelSpectrogram(
            sr=cfg["sampling_rate"], n_mels=cfg["num_mels"], n_fft=cfg["n_fft"],
            win_size=cfg["win_size"], hop_length=cfg["hop_size"],
            fmin=cfg["fmin"], fmax=cfg["fmax"])
        self.model = Generator(
            sampling_rate=cfg["sampling_rate"], num_mels=cfg["num_mels"],
            upsample_rates=tuple(cfg["upsample_rates"]),
            upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
            upsample_initial_channel=cfg["upsample_initial_channel"],
            resblock=str(cfg["resblock"]),
            resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in cfg["resblock_dilation_sizes"]))

    def extract(self, audio: torch.Tensor, sample_rate: int = 0) -> torch.Tensor:
        """audio (B, L) -> mel (B, T, M)."""
        if sample_rate not in (0, self.vocoder_sample_rate):
            raise NotImplementedError("resampling is not ported: pass audio "
                                      "at the vocoder's sample rate")
        return self.mel.extract(audio)

    def infer(self, mel: torch.Tensor, f0: torch.Tensor, sine_kwargs=None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """mel (B, T, M), f0 (B, T', 1) or (B, T') -> audio (B, T * hop); f0
        is trimmed to the mel's frame count."""
        if f0.dim() == 3:
            f0 = f0[..., 0]
        return self.model(mel, f0[:, :mel.shape[1]], sine_kwargs, generator)
