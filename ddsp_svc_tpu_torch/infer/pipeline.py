"""The DiffusionFast serving path (mirrors the direct path of
ddsp_svc_tpu/infer/pipeline.py ``SvcPipeline.infer``, the jitted ``fwd``
with silence_front = 0): cascade -> NSF-HiFiGAN -> volume mask.

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
    """DiffusionFast model + NSF-HiFiGAN vocoder on one device (the CUDA
    card unless ``device`` says otherwise)."""

    def __init__(self, model_path: str, device: str | torch.device | None = None,
                 seed: int = 0):
        """Load a JAX checkpoint, its config.yaml and the vocoder payload the
        config names (random init when that file does not exist)."""
        from ..models.registry import load_model, load_vocoder
        from ..models.vocoder import Vocoder

        dev = resolve_device(device)
        model, args = load_model(model_path)
        vc = args.vocoder or {}
        vocoder = load_vocoder(vc.get("ckpt"))
        if vocoder is None:
            from ..models.nn import random_init_

            print(f" [!] vocoder checkpoint {vc.get('ckpt')!r} not found - random init")
            vocoder = Vocoder(vc.get("type", "nsf-hifigan"))
            random_init_(vocoder, torch.Generator().manual_seed(seed))
        self._init(model, args, vocoder, dev, seed)

    @classmethod
    def from_parts(cls, model, params, args, vocoder,
                   device: str | torch.device | None = None,
                   seed: int = 0) -> "SvcPipeline":
        """Build a pipeline in memory: ``model`` a Unit2WavFast, ``params``
        its state dict (None keeps the model's weights), ``args`` the
        DotDict config, ``vocoder`` a Vocoder."""
        dev = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, strict=True)
        self = cls.__new__(cls)
        self._init(model, args, vocoder, dev, seed)
        return self

    def _init(self, model, args, vocoder, device, seed):
        self.device = device
        self.args = args
        self.model = model.to(device).eval()
        self.vocoder = vocoder.to(device).eval()
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
                       method: str = "dpm-solver", noise: dict | None = None):
        """units (1, T, n_unit), f0 (1, T, 1) Hz, volume (1, T, 1), frame_mask
        (T,) -> (audio (1, T * hop) on the pipeline's device, sample rate).

        ``noise`` may carry any of ``ddsp`` (1, T * block), ``diffusion``
        (1, T, M), ``rand_ini`` (1, 1, 9) and ``sine`` (1, T * hop, 9); what
        is missing is drawn from the pipeline's generator."""
        mel = self.cascade(units, f0, volume, spk_id, k_step, speedup, method,
                           noise)
        return (self.vocode(mel, f0, frame_mask, noise),
                self.vocoder.vocoder_sample_rate)

    @torch.no_grad()
    def cascade(self, units, f0, volume, spk_id: int = 1,
                k_step: int | None = None, speedup: int = 10,
                method: str = "dpm-solver", noise: dict | None = None):
        """The first half of ``infer_features``: the DiffusionFast mel
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
        mask = upsample(_as_tensor(frame_mask, dev)[None, :, None],
                        int(self.args.data.block_size))[..., 0]
        return audio * mask[:, :audio.shape[-1]]
