"""NSF-HiFiGAN vocoder wrapper and the DDSP models' output enhancer
(mirrors ddsp_svc_tpu/models/vocoder.py: ``DEFAULT_NSF_CONFIG``,
``Vocoder.extract``, ``Vocoder.infer``, ``Enhancer.enhance``) for the
'nsf-hifigan' type and its 'nsf-hifigan-log10' variant, whose mels are
scaled by log10(e) = 0.434294 on extract and back on infer."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mel import LogMelSpectrogram
from ..ops.resample import resample
from ..utils.device import resolve_device
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


VOCODER_TYPES = ("nsf-hifigan", "nsf-hifigan-log10")
LOG10_E = 0.434294


class Vocoder(nn.Module):
    """``infer(..., dtype=torch.bfloat16)`` runs the generator in bf16 (the
    JAX Vocoder's ``dtype``, vocoder.py:61-160); the parameters stay float32
    and ``infer`` returns float32 audio. The type is chosen per call, so one
    set of weights serves both."""

    def __init__(self, vocoder_type: str = "nsf-hifigan",
                 config: dict | None = None):
        super().__init__()
        if vocoder_type not in VOCODER_TYPES:
            raise ValueError(f"unknown vocoder type {vocoder_type!r}: "
                             f"{', '.join(VOCODER_TYPES)}")
        self.type = vocoder_type
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

    def extract(self, audio: torch.Tensor, sample_rate: int = 0,
                keyshift: float = 0.0) -> torch.Tensor:
        """audio (B, L) at ``sample_rate`` (0: the vocoder's) -> mel (B, T, M),
        with the mel's ``keyshift`` in semitones."""
        if sample_rate not in (0, self.vocoder_sample_rate):
            audio = resample(audio, sample_rate, self.vocoder_sample_rate)
        mel = self.mel.extract(audio, keyshift=keyshift)
        return LOG10_E * mel if self.type == "nsf-hifigan-log10" else mel

    def infer(self, mel: torch.Tensor, f0: torch.Tensor, sine_kwargs=None,
              generator: torch.Generator | None = None,
              dtype: torch.dtype | None = None) -> torch.Tensor:
        """mel (B, T, M), f0 (B, T', 1) or (B, T') -> audio (B, T * hop)
        float32; f0 is trimmed to the mel's frame count. ``dtype``: the
        generator's compute type (default float32)."""
        if self.type == "nsf-hifigan-log10":
            mel = mel / LOG10_E
        if f0.dim() == 3:
            f0 = f0[..., 0]
        return self.model(mel, f0[:, :mel.shape[1]], sine_kwargs, generator,
                          dtype=dtype).float()


class Enhancer:
    """NSF-HiFiGAN re-synthesis of a DDSP model's output, on one device
    (the CUDA card unless ``device`` says otherwise). ``vocoder`` is a
    Vocoder in memory; without one the converted payload ``ckpt`` is read,
    and random weights from ``seed`` stand in when that file is absent.
    ``dtype=torch.bfloat16`` runs its generator in bf16 (the JAX Enhancer's
    ``dtype``, vocoder.py:161-167); the vocoder's weights are shared as they
    are."""

    def __init__(self, enhancer_type: str = "nsf-hifigan", ckpt: str | None = None,
                 device: str | torch.device | None = None,
                 vocoder: Vocoder | None = None, seed: int = 0,
                 dtype: torch.dtype | None = None):
        if enhancer_type not in VOCODER_TYPES:
            raise ValueError(f"unknown enhancer type {enhancer_type!r}: "
                             f"{', '.join(VOCODER_TYPES)}")
        self.device = resolve_device(device)
        if vocoder is None:
            from .registry import load_vocoder_or_random

            vocoder = load_vocoder_or_random(ckpt, seed, enhancer_type)
        if vocoder.type != enhancer_type:
            raise ValueError(f"enhancer type {enhancer_type!r} with a "
                             f"{vocoder.type!r} vocoder")
        self.vocoder = vocoder.to(self.device).eval()
        self.dtype = dtype

    @torch.no_grad()
    def enhance(self, audio: torch.Tensor, sample_rate: int, f0: torch.Tensor,
                hop_size: int, adaptive_key: float | str = 0,
                silence_front: float = 0, noise: dict | None = None,
                generator: torch.Generator | None = None):
        """audio (B, L) at ``sample_rate``, f0 (B, T, 1) on the caller's hop
        grid -> (audio at the vocoder's rate, that rate).

        ``adaptive_key`` (semitones, or "auto" from the peak f0) resamples
        the input up so the vocoder sees its pitch lowered, and the output
        back; ``silence_front`` seconds are skipped and padded back as
        silence. ``noise`` may carry the vocoder's ``rand_ini`` (1, 1, 9)
        and ``sine`` (B, >= frames * hop, 9) draws; the rest comes from
        ``generator``."""
        v = self.vocoder
        start_frame = int(silence_front * sample_rate / hop_size)
        real_silence_front = start_frame * hop_size / sample_rate
        audio = audio[:, int(np.round(real_silence_front * sample_rate)):]
        f0 = f0[:, start_frame:, :]
        if adaptive_key == "auto":
            adaptive_key = 12 * np.log2(float(torch.max(f0)) / 760.0)
            adaptive_key = max(0.0, float(np.ceil(adaptive_key)))
        adaptive_factor = 2 ** (-float(adaptive_key) / 12.0)
        adaptive_sr = 100 * int(np.round(v.vocoder_sample_rate
                                         / adaptive_factor / 100))
        real_factor = v.vocoder_sample_rate / adaptive_sr
        if sample_rate != adaptive_sr:
            audio = resample(audio, sample_rate, adaptive_sr)
        n_frames = int(audio.shape[-1] // v.vocoder_hop_size + 1)
        mel = v.extract(audio)
        # f0 onto the vocoder's hop grid: scaled by real_factor, source
        # times stretched by 1 / real_factor, edges held (host numpy, as JAX)
        f0_np = f0[:, :, 0].detach().cpu().numpy()
        if not (hop_size == v.vocoder_hop_size
                and sample_rate == v.vocoder_sample_rate == adaptive_sr):
            f0_np = f0_np * real_factor
            src_t = (hop_size / sample_rate) * np.arange(f0_np.shape[1]) / real_factor
            tgt_t = (v.vocoder_hop_size / v.vocoder_sample_rate) * np.arange(n_frames)
            f0_np = np.stack([np.interp(tgt_t, src_t, row, left=row[0], right=row[-1])
                              for row in f0_np], axis=0)
        f0_grid = torch.as_tensor(np.asarray(f0_np, np.float32), device=self.device)
        enhanced = v.infer(mel, f0_grid, self._sine_kwargs(noise, mel.shape[1]),
                           generator=generator, dtype=self.dtype)
        out_sr = v.vocoder_sample_rate
        if adaptive_sr != out_sr:
            enhanced = resample(enhanced, adaptive_sr, out_sr)
        if start_frame > 0:
            enhanced = F.pad(enhanced, (int(np.round(out_sr * real_silence_front)), 0))
        return enhanced, out_sr

    def _sine_kwargs(self, noise: dict | None, n_frames: int) -> dict | None:
        if not noise:
            return None
        out = {}
        if "rand_ini" in noise:
            out["rand_ini"] = torch.as_tensor(noise["rand_ini"], dtype=torch.float32,
                                              device=self.device)
        if "sine" in noise:
            n = n_frames * self.vocoder.vocoder_hop_size
            sine = torch.as_tensor(noise["sine"], dtype=torch.float32,
                                   device=self.device)
            if sine.shape[1] < n:
                raise ValueError(f"enhancer sine noise has {sine.shape[1]} "
                                 f"samples, the request needs {n}")
            out["noise"] = sine[:, :n]
        return out or None
