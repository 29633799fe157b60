"""The serving path from features (mirrors the direct path of
ddsp_svc_tpu/infer/pipeline.py ``SvcPipeline.infer``) for two families:

- DiffusionFast (the jitted ``fwd`` with silence_front 0): cascade ->
  NSF-HiFiGAN -> volume mask;
- the DDSP family (Sins, CombSub, CombSubFast, CombSubSuperFast): synth ->
  volume mask -> the NSF-HiFiGAN ``Enhancer`` when ``enhance`` is set and
  the config names an ``enhancer``.

The front-end (units encoder, f0 tracker) is not ported yet, so the entry
point takes the features it would produce: ``infer_features``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..features.volume import VolumeExtractor
from ..ops.interp import upsample
from ..utils.device import resolve_device


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _maybe(noise: dict, name: str, device):
    return _as_tensor(noise[name], device) if name in noise else None


class SvcPipeline:
    """A model of a ported family and its NSF-HiFiGAN (the vocoder of the
    diffusion family, the enhancer of the DDSP family) on one device (the
    CUDA card unless ``device`` says otherwise)."""

    def __init__(self, model_path: str, device: str | torch.device | None = None,
                 seed: int = 0, enhance: bool = False):
        """Load a JAX checkpoint, its config.yaml and the NSF-HiFiGAN payload
        the config names (``vocoder`` or, with ``enhance``, ``enhancer``;
        random init when that file does not exist)."""
        from ..models.registry import (load_model, load_vocoder_or_random,
                                       model_family)

        dev = resolve_device(device)
        model, args = load_model(model_path, device="cpu")
        if model_family(args.model.type) == "ddsp":
            vc = args.enhancer if enhance else None
        else:
            vc = args.vocoder or {}
        vocoder = load_vocoder_or_random(vc.get("ckpt"), seed) if vc is not None else None
        self._init(model, args, vocoder, dev, seed, enhance)

    @classmethod
    def from_parts(cls, model, params, args, vocoder,
                   device: str | torch.device | None = None,
                   seed: int = 0, enhance: bool = False) -> "SvcPipeline":
        """Build a pipeline in memory: ``model`` a module of a ported family,
        ``params`` its state dict (None keeps the model's weights), ``args``
        the DotDict config, ``vocoder`` a Vocoder (for the DDSP family, the
        enhancer's; used when ``enhance`` is set and args has ``enhancer``)."""
        dev = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, strict=True)
        self = cls.__new__(cls)
        self._init(model, args, vocoder, dev, seed, enhance)
        return self

    def _init(self, model, args, vocoder, device, seed, enhance):
        from ..models.registry import model_family
        from ..models.vocoder import Enhancer

        self.device = device
        self.args = args
        self.family = model_family(args.model.type)
        self.model = model.to(device).eval()
        self.vocoder = self.enhancer = None
        if self.family != "ddsp":
            self.vocoder = vocoder.to(device).eval()
        elif enhance and args.enhancer:
            if vocoder is None:
                raise ValueError("enhance=True needs the enhancer's vocoder")
            self.enhancer = Enhancer(args.enhancer.type or "nsf-hifigan",
                                     device=device, vocoder=vocoder)
        # per-request noise when none is injected
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def volume_and_mask(self, audio: np.ndarray, threshold: float = -60.0):
        """Host-side features of a waveform at the model's rate: (volume
        (1, T, 1), frame mask (T,)) with T = len // block + 1."""
        vx = VolumeExtractor(int(self.args.data.block_size))
        volume = vx.extract(np.asarray(audio, np.float32))
        return volume[None, :, None], vx.get_mask(volume, threshold)

    @torch.no_grad()
    def infer_features(self, units, f0, volume, frame_mask, spk_id: int = 1,
                       k_step: int | None = None, speedup: int = 10,
                       method: str = "dpm-solver", noise: dict | None = None,
                       enhancer_adaptive_key: float | str = 0.0,
                       silence_front: float = 0.0):
        """units (1, T, n_unit), f0 (1, T, 1) Hz, volume (1, T, 1), frame_mask
        (T,) -> (audio (1, L) on the pipeline's device, its sample rate).

        ``noise`` may carry any of ``ddsp`` (1, T * block), ``diffusion``
        (1, T, M), ``rand_ini`` (1, 1, 9) and ``sine`` (1, >= L, 9); what
        is missing is drawn from the pipeline's generator. The diffusion
        family reads k_step, speedup and method; the DDSP family's enhancer
        reads ``enhancer_adaptive_key`` and ``silence_front``."""
        if self.family == "ddsp":
            return self._infer_ddsp(units, f0, volume, frame_mask, spk_id,
                                    noise or {}, enhancer_adaptive_key,
                                    silence_front)
        mel = self.cascade(units, f0, volume, spk_id, k_step, speedup, method,
                           noise)
        return (self.vocode(mel, f0, frame_mask, noise),
                self.vocoder.vocoder_sample_rate)

    def _volume_mask(self, audio, frame_mask):
        mask = upsample(_as_tensor(frame_mask, self.device)[None, :, None],
                        int(self.args.data.block_size))[..., 0]
        return audio * mask[:, :audio.shape[-1]]

    def _infer_ddsp(self, units, f0, volume, frame_mask, spk_id, noise,
                    adaptive_key, silence_front):
        """Synth -> volume mask -> enhancer (JAX: the masked direct forward,
        then ``Enhancer.enhance`` on the masked audio)."""
        dev = self.device
        units, f0, volume = (_as_tensor(a, dev) for a in (units, f0, volume))
        spk = torch.full((units.shape[0], 1), int(spk_id), device=dev,
                         dtype=torch.long)
        audio, _ = self.model(units, f0, volume, spk_id=spk,
                              noise=_maybe(noise, "ddsp", dev),
                              generator=self.generator)
        audio = self._volume_mask(audio, frame_mask)
        if self.enhancer is None:
            return audio, int(self.args.data.sampling_rate)
        return self.enhancer.enhance(
            audio, int(self.args.data.sampling_rate), f0,
            int(self.args.data.block_size), adaptive_key=adaptive_key,
            silence_front=silence_front, noise=noise, generator=self.generator)

    @torch.no_grad()
    def cascade(self, units, f0, volume, spk_id: int = 1,
                k_step: int | None = None, speedup: int = 10,
                method: str = "dpm-solver", noise: dict | None = None):
        """The first half of ``infer_features`` for DiffusionFast: the mel
        (1, T, M). k_step defaults to, and is clamped by, k_step_max."""
        if method != "dpm-solver":
            raise NotImplementedError(
                f"method {method!r}: only 'dpm-solver' is ported")
        args, dev = self.args, self.device
        noise = noise or {}
        units, f0, volume = (_as_tensor(a, dev) for a in (units, f0, volume))
        k_max = int(args.model.k_step_max or 1000)
        k_step = min(int(k_step or k_max), k_max)
        spk = torch.full((units.shape[0], 1), int(spk_id), device=dev,
                         dtype=torch.long)
        return self.model(
            units, f0, volume, spk_id=spk,
            mel_extract_fn=lambda wav: self.vocoder.extract(
                wav, int(args.data.sampling_rate)),
            infer_speedup=speedup, sampler=method, k_step=k_step,
            ddsp_noise=_maybe(noise, "ddsp", dev),
            init_noise=_maybe(noise, "diffusion", dev),
            generator=self.generator)

    @torch.no_grad()
    def vocode(self, mel, f0, frame_mask, noise: dict | None = None):
        """The second half: NSF-HiFiGAN on the mel, then the volume mask."""
        dev = self.device
        noise = noise or {}
        sine_kwargs = {key: _maybe(noise, name, dev)
                       for key, name in (("rand_ini", "rand_ini"),
                                         ("noise", "sine")) if name in noise}
        audio = self.vocoder.infer(mel, _as_tensor(f0, dev), sine_kwargs or None,
                                   generator=self.generator)
        return self._volume_mask(audio, frame_mask)
