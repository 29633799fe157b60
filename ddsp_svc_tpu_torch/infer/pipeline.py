"""The voice-conversion pipeline (mirrors the direct, unbatched path of
ddsp_svc_tpu/infer/pipeline.py ``SvcPipeline.infer``): a recording in,
the converted recording out, for every model family:

- the mel cascades (Diffusion, DiffusionNew, DiffusionFast,
  RectifiedFlow): front end -> cascade -> NSF-HiFiGAN -> volume mask, with
  the ``silence_front`` prefix left out of the vocoder (or, with
  ``use_silence``, out of the whole cascade) and padded back as silence;
- the DDSP family (Sins, CombSub, CombSubFast, CombSubSuperFast): front end
  -> synth -> volume mask -> the NSF-HiFiGAN ``Enhancer`` when ``enhance``
  is set and the config names an ``enhancer``.

The front end (``front_end``) is the units encoder on the device, YIN f0
on the host (or on the device with ``device_f0``) with the key shift, and
the volume and its frame mask on the host. ``infer_features`` takes the
features themselves. A speaker mix ``spk_mix_dict`` {id: weight} replaces
``spk_id`` on every path.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..features.f0 import F0Extractor
from ..features.volume import VolumeExtractor
from ..ops.interp import upsample
from ..utils.device import resolve_device

def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _maybe(noise: dict, name: str, device):
    return _as_tensor(noise[name], device) if name in noise else None


def _speaker(spk_id, batch: int, device) -> torch.Tensor:
    return torch.full((batch, 1), int(spk_id), device=device, dtype=torch.long)


class SvcPipeline:
    """A model of any family and its NSF-HiFiGAN (the vocoder of the mel
    cascades, the enhancer of the DDSP family) on one device (the CUDA card
    unless ``device`` says otherwise)."""

    def __init__(self, model_path: str, device: str | torch.device | None = None,
                 seed: int = 0, enhance: bool = False,
                 pitch_extractor: str = "yin", f0_min: float = 50.0,
                 f0_max: float = 1100.0, device_f0: bool = False):
        """Load a JAX checkpoint, its config.yaml, the units encoder the
        config names (its converted weights, or random ones from ``seed``;
        a config that names none serves ``infer_features`` only) and the
        NSF-HiFiGAN payload it names (``vocoder`` or, with ``enhance``,
        ``enhancer``; random init when that file does not exist)."""
        from ..cli.common import build_units_encoder
        from ..models.registry import (load_model, load_vocoder_or_random,
                                       model_family)

        dev = resolve_device(device)
        model, args = load_model(model_path, device="cpu")
        if model_family(args.model.type) == "ddsp":
            vc = args.enhancer if enhance else None
        else:
            vc = args.vocoder or {}
        vocoder = (load_vocoder_or_random(vc.get("ckpt"), seed,
                                          vc.get("type") or "nsf-hifigan")
                   if vc is not None else None)
        encoder = build_units_encoder(args, dev, seed) if args.data.encoder else None
        self._init(model, args, vocoder, dev, seed, enhance, encoder,
                   pitch_extractor, f0_min, f0_max, device_f0)

    @classmethod
    def from_parts(cls, model, params, args, vocoder,
                   device: str | torch.device | None = None,
                   seed: int = 0, enhance: bool = False, units_encoder=None,
                   pitch_extractor: str = "yin", f0_min: float = 50.0,
                   f0_max: float = 1100.0,
                   device_f0: bool = False) -> "SvcPipeline":
        """Build a pipeline in memory: ``model`` a module of any family,
        ``params`` its state dict (None keeps the model's weights), ``args``
        the DotDict config, ``vocoder`` a Vocoder (for the DDSP family, the
        enhancer's; used when ``enhance`` is set and args has ``enhancer``),
        ``units_encoder`` a UnitsEncoder on the same device (``infer``
        needs one; ``infer_features`` does not)."""
        dev = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, strict=True)
        self = cls.__new__(cls)
        self._init(model, args, vocoder, dev, seed, enhance, units_encoder,
                   pitch_extractor, f0_min, f0_max, device_f0)
        return self

    def _init(self, model, args, vocoder, device, seed, enhance, units_encoder,
              pitch_extractor, f0_min, f0_max, device_f0):
        from ..models.registry import model_family
        from ..models.vocoder import Enhancer

        if units_encoder is not None and units_encoder.device != device:
            raise ValueError(f"the units encoder is on {units_encoder.device}, "
                             f"the pipeline on {device}")
        self.device = device
        self.args = args
        self.units_encoder = units_encoder
        self.pitch_extractor = pitch_extractor
        self.f0_min, self.f0_max = f0_min, f0_max
        # the device YIN mirrors the host 'yin' extractor only
        self.device_f0 = bool(device_f0) and pitch_extractor == "yin"
        self._f0_extractors: dict[int, F0Extractor] = {}
        self._f0_fns: dict[tuple, object] = {}
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

    def hop_size(self, sample_rate: int) -> int:
        """The model's frame hop in samples at ``sample_rate``."""
        return int(self.args.data.block_size * sample_rate
                   / self.args.data.sampling_rate)

    def volume_and_mask(self, audio: np.ndarray, threshold: float = -60.0,
                        hop_size: int | None = None):
        """Host-side features of a waveform: (volume (1, T, 1), frame mask
        (T,)) with T = len // hop + 1 (hop: the model's block size unless
        given)."""
        vx = VolumeExtractor(int(hop_size or self.args.data.block_size))
        volume = vx.extract(np.asarray(audio, np.float32))
        return volume[None, :, None], vx.get_mask(volume, threshold)

    def encode_units(self, audio, sample_rate: int) -> torch.Tensor:
        """audio (L,) -> units (1, L // hop + 1, n_unit) on the device,
        inside the profiler range "units_encoder"."""
        if self.units_encoder is None:
            raise ValueError("this pipeline has no units encoder (from_parts "
                             "takes one as units_encoder=)")
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        # a profiler range, so a trace can tell the encoder's kernels apart
        with torch.profiler.record_function("units_encoder"):
            return self.units_encoder.encode(audio[None], sample_rate,
                                             self.hop_size(sample_rate))

    def extract_f0(self, audio, sample_rate: int, key_shift: float = 0.0,
                   silence_front: float = 0.0):
        """audio (L,) -> f0 (1, L // hop + 1, 1) in Hz, unvoiced frames
        interpolated and floored at f0_min, shifted by ``key_shift``
        semitones in f32: a host array, or with ``device_f0`` a tensor on
        the device (the device YIN; ``audio`` may then lie there already)."""
        hop = self.hop_size(sample_rate)
        start_frame = int(silence_front * sample_rate / hop)
        if self.device_f0:
            from ..features.yin_device import make_pipeline_f0_fn

            audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
            key = (audio.shape[-1], sample_rate, hop, start_frame)
            if key not in self._f0_fns:
                self._f0_fns[key] = make_pipeline_f0_fn(
                    audio.shape[-1], sample_rate, hop, self.f0_min,
                    self.f0_max, start_frame)
            return self._f0_fns[key](audio)[None, :, None] * 2 ** (key_shift / 12.0)
        f0 = self.f0_extractor(sample_rate).extract(
            np.asarray(audio), uv_interp=True, silence_front=silence_front)
        return f0[None, :, None] * np.float32(2 ** (key_shift / 12.0))

    def f0_extractor(self, sample_rate: int) -> F0Extractor:
        """The host f0 tracker for inputs at ``sample_rate``."""
        if sample_rate not in self._f0_extractors:
            self._f0_extractors[sample_rate] = F0Extractor(
                self.pitch_extractor, sample_rate, self.hop_size(sample_rate),
                self.f0_min, self.f0_max)
        return self._f0_extractors[sample_rate]

    @torch.no_grad()
    def front_end(self, audio: np.ndarray, sample_rate: int,
                  key_shift: float = 0.0, threhold: float = -60.0,
                  silence_front: float = 0.0) -> dict:
        """1-D audio at any rate -> the model's inputs: ``units`` (1, T,
        n_unit) on the device, ``f0`` (1, T, 1) (see ``extract_f0``),
        ``volume`` (1, T, 1) and ``frame_mask`` (T,) on the host, T = L //
        hop + 1 with hop the model's block at ``sample_rate``."""
        audio = np.asarray(audio, np.float32)
        # one upload serves the encoder and, with device_f0, the YIN
        on_device = torch.as_tensor(audio, device=self.device)
        units = self.encode_units(on_device, sample_rate)
        t = units.shape[1]
        f0 = self.extract_f0(on_device if self.device_f0 else audio, sample_rate,
                             key_shift, silence_front)
        volume, frame_mask = self.volume_and_mask(audio, threhold,
                                                  self.hop_size(sample_rate))
        return dict(units=units, f0=f0[:, :t], volume=volume[:, :t],
                    frame_mask=frame_mask)

    @torch.no_grad()
    def infer(self, audio: np.ndarray, sample_rate: int, spk_id: int = 1,
              key_shift: float = 0.0, threhold: float = -60.0,
              silence_front: float = 0.0,
              enhancer_adaptive_key: float | str = 0.0, spk_mix_dict=None,
              use_silence: bool = False, k_step: int | None = None,
              speedup: int = 10, method: str | None = None,
              infer_step: int | None = None, t_start: float | None = None,
              noise: dict | None = None) -> tuple[np.ndarray, int]:
        """1-D float audio at ``sample_rate`` -> (converted audio (L',) on
        the host, its sample rate).

        ``silence_front`` seconds: the mel cascades crop that many frames of
        the mel before NSF-HiFiGAN and pad the audio back with silence; with
        ``use_silence`` the whole cascade runs on the cropped frames. The
        DDSP family's enhancer skips them likewise. The sampler settings as
        ``cascade`` resolves them; ``noise`` as in ``infer_features`` (with
        the DDPM chain's ``chain``), at the frame count the model runs at."""
        fe = self.front_end(audio, sample_rate, key_shift, threhold,
                            silence_front)
        units, f0, volume = fe["units"], fe["f0"], fe["volume"]
        if self.family == "ddsp":
            out, out_sr = self._infer_ddsp(
                units, f0, volume, fe["frame_mask"], spk_id, noise or {},
                enhancer_adaptive_key, silence_front, spk_mix_dict)
            return out[0].cpu().numpy(), out_sr
        t = units.shape[1]
        v = self.vocoder
        start_frame = 0
        if silence_front > 0:
            start_frame = min(int(silence_front * v.vocoder_sample_rate
                                  / v.vocoder_hop_size), t - 1)
        if use_silence and start_frame > 0:
            units, f0, volume = (a[:, start_frame:] for a in (units, f0, volume))
        mel = self.cascade(units, f0, volume, spk_id, k_step, speedup, method,
                           noise, infer_step=infer_step, t_start=t_start,
                           spk_mix_dict=spk_mix_dict)
        if not use_silence and start_frame > 0:
            # never vocode the stale prefix
            mel, f0 = mel[:, start_frame:], f0[:, start_frame:]
        out = self.vocode(mel, f0, fe["frame_mask"], noise, start_frame)
        return out[0].cpu().numpy(), v.vocoder_sample_rate

    @torch.no_grad()
    def infer_features(self, units, f0, volume, frame_mask, spk_id: int = 1,
                       k_step: int | None = None, speedup: int = 10,
                       method: str | None = None, noise: dict | None = None,
                       enhancer_adaptive_key: float | str = 0.0,
                       silence_front: float = 0.0, infer_step: int | None = None,
                       t_start: float | None = None, spk_mix_dict=None):
        """units (1, T, n_unit), f0 (1, T, 1) Hz, volume (1, T, 1), frame_mask
        (T,) -> (audio (1, L) on the pipeline's device, its sample rate).

        ``noise`` may carry any of ``ddsp`` (1, T * block), ``diffusion``
        (1, T, M; the rectified flow's and the diffusions' initial noise),
        the DDPM chain's ``chain`` (k_step, 1, T, M), ``rand_ini`` (1, 1, 9)
        and ``sine`` (1, >= L, 9); what is missing is drawn from the
        pipeline's generator. The cascades read the sampler settings
        (``cascade``); the DDSP family's enhancer reads
        ``enhancer_adaptive_key`` and ``silence_front``."""
        if self.family == "ddsp":
            return self._infer_ddsp(units, f0, volume, frame_mask, spk_id,
                                    noise or {}, enhancer_adaptive_key,
                                    silence_front, spk_mix_dict)
        mel = self.cascade(units, f0, volume, spk_id, k_step, speedup, method,
                           noise, infer_step=infer_step, t_start=t_start,
                           spk_mix_dict=spk_mix_dict)
        return (self.vocode(mel, f0, frame_mask, noise),
                self.vocoder.vocoder_sample_rate)

    def apply_volume_mask(self, audio, frame_mask):
        """audio (1, L) times the frame mask (T,) upsampled to samples."""
        mask = upsample(_as_tensor(frame_mask, self.device)[None, :, None],
                        int(self.args.data.block_size))[..., 0]
        return audio * mask[:, :audio.shape[-1]]

    def _infer_ddsp(self, units, f0, volume, frame_mask, spk_id, noise,
                    adaptive_key, silence_front, spk_mix_dict=None):
        """Synth -> volume mask -> enhancer (JAX: the masked direct forward,
        then ``Enhancer.enhance`` on the masked audio)."""
        audio = self.apply_volume_mask(
            self.synth_ddsp(units, f0, volume, spk_id, noise, spk_mix_dict),
            frame_mask)
        return self.enhance(audio, f0, adaptive_key, silence_front, noise)

    @torch.no_grad()
    def synth_ddsp(self, units, f0, volume, spk_id: int = 1,
                   noise: dict | None = None, spk_mix_dict=None,
                   model=None) -> torch.Tensor:
        """The DDSP family's synth alone (or ``model``, a DDSP model on the
        pipeline's device): audio (1, T * block) at the model's rate,
        unmasked."""
        dev = self.device
        units, f0, volume = (_as_tensor(a, dev) for a in (units, f0, volume))
        audio, _ = (model or self.model)(
            units, f0, volume, spk_id=_speaker(spk_id, units.shape[0], dev),
            noise=_maybe(noise or {}, "ddsp", dev), generator=self.generator,
            spk_mix_dict=spk_mix_dict)
        return audio

    @torch.no_grad()
    def enhance(self, audio, f0, adaptive_key: float | str = 0.0,
                silence_front: float = 0.0, noise: dict | None = None):
        """The DDSP family's enhancer on audio at the model's rate (itself
        when the pipeline has none) -> (audio, sample rate)."""
        sr = int(self.args.data.sampling_rate)
        if self.enhancer is None:
            return audio, sr
        return self.enhancer.enhance(
            audio, sr, _as_tensor(f0, self.device), int(self.args.data.block_size),
            adaptive_key=adaptive_key, silence_front=silence_front, noise=noise,
            generator=self.generator)

    def sampler_kwargs(self, k_step: int | None = None, speedup: int = 10,
                       method: str | None = None, infer_step: int | None = None,
                       t_start: float | None = None) -> dict:
        """A cascade request's sampler settings, resolved as the JAX
        pipeline's ``_sampler_kwargs``. The diffusions: k_step defaults to,
        and is clamped by, k_step_max; ``method`` (default 'dpm-solver')
        is 'dpm-solver', 'unipc', 'pndm' or 'ddim' at ``speedup``, or with
        ``speedup`` 1 the full DDPM chain. The rectified flow:
        ``infer_step`` (default 20) steps of ``method`` (default 'euler',
        or 'rk4') from ``t_start`` (default the config's)."""
        args = self.args
        if self.family == "reflow":
            return dict(
                infer_step=20 if infer_step is None else int(infer_step),
                sampler=method or "euler",
                t_start=(float(args.model.t_start or 0.0) if t_start is None
                         else float(t_start)))
        k_max = int(args.model.k_step_max or 1000)
        return dict(infer_speedup=speedup, sampler=method or "dpm-solver",
                    k_step=min(int(k_step or k_max), k_max))

    @torch.no_grad()
    def cascade(self, units, f0, volume, spk_id: int = 1,
                k_step: int | None = None, speedup: int = 10,
                method: str | None = None, noise: dict | None = None, *,
                infer_step: int | None = None, t_start: float | None = None,
                spk_mix_dict=None, formant_shift: float = 0.0, gt_spec=None):
        """The first half of ``infer_features`` for the mel cascades: the mel
        (1, T, M), with the sampler settings of ``sampler_kwargs``.
        ``formant_shift`` semitones feed the pitch-aug embedding
        (``aug_shift``); ``gt_spec`` (1, T, M), an external DDSP model's
        mel, starts a Unit2Mel shallow at k_step."""
        args, dev = self.args, self.device
        noise = noise or {}
        units, f0, volume = (_as_tensor(a, dev) for a in (units, f0, volume))
        kwargs = self.sampler_kwargs(k_step, speedup, method, infer_step, t_start)
        kwargs.update(spk_id=_speaker(spk_id, units.shape[0], dev),
                      spk_mix_dict=spk_mix_dict, generator=self.generator,
                      init_noise=_maybe(noise, "diffusion", dev))
        if formant_shift:
            kwargs["aug_shift"] = torch.full((units.shape[0], 1, 1),
                                             float(formant_shift), device=dev)
        if self.family != "reflow":
            kwargs["chain_noise"] = _maybe(noise, "chain", dev)
        if self.family == "unit2mel":
            kwargs["gt_spec"] = None if gt_spec is None else _as_tensor(gt_spec, dev)
        else:
            if gt_spec is not None:
                raise ValueError("gt_spec (an external DDSP model's mel) seeds "
                                 "the Diffusion (Unit2Mel) family only; the "
                                 "other cascades run their own DDSP stage")
            kwargs.update(ddsp_noise=_maybe(noise, "ddsp", dev),
                          mel_extract_fn=lambda wav: self.vocoder.extract(
                              wav, int(args.data.sampling_rate)))
        return self.model(units, f0, volume, **kwargs)

    @torch.no_grad()
    def vocode(self, mel, f0, frame_mask=None, noise: dict | None = None,
               pad_frames: int = 0):
        """The second half: NSF-HiFiGAN on the mel, ``pad_frames`` frames of
        silence in front, then the volume mask over the padded length (none
        without ``frame_mask``)."""
        dev = self.device
        noise = noise or {}
        n = mel.shape[1] * self.vocoder.vocoder_hop_size
        sine_kwargs = {}
        if "rand_ini" in noise:
            sine_kwargs["rand_ini"] = _maybe(noise, "rand_ini", dev)
        if "sine" in noise:
            sine_kwargs["noise"] = _maybe(noise, "sine", dev)[:, :n]
        audio = self.vocoder.infer(mel, _as_tensor(f0, dev), sine_kwargs or None,
                                   generator=self.generator)
        if pad_frames:
            audio = F.pad(audio, (pad_frames * self.vocoder.vocoder_hop_size, 0))
        return audio if frame_mask is None else self.apply_volume_mask(audio, frame_mask)
