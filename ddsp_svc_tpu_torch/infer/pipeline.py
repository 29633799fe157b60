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

``enable_batching`` routes ``infer`` through the dynamic batchers
(infer/batcher.py, infer/enc_batcher.py; JAX pipeline.py:114-455): the
DDSP synth alone, the DDSP synth with the volume mask and the enhancer in
one batched forward, or a cascade with the vocoder and the live-frame mask.
A request longer than the largest bucket, a sampler signature past
``max_signatures``, a speaker mix or injected noise runs the direct path.

Random state: every request draws its noise from a generator of its own,
seeded from the pipeline's seed sequence under a lock (or from the caller's
``seed``), so concurrent requests never share one.
"""
from __future__ import annotations

import copy
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..features.f0 import F0Extractor
from ..features.volume import VolumeExtractor, get_mask_batch
from ..ops.interp import upsample
from ..utils.device import resolve_device

def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _maybe(noise: dict, name: str, device):
    return _as_tensor(noise[name], device) if name in noise else None


def _speaker(spk_id, batch: int, device) -> torch.Tensor:
    """An int id for every row, or a (B, 1) tensor of ids as it is."""
    if isinstance(spk_id, torch.Tensor):
        return spk_id.to(device=device, dtype=torch.long)
    return torch.full((batch, 1), int(spk_id), device=device, dtype=torch.long)


def _cat_noise(rows: list[dict]) -> dict:
    """Per-row noise dicts -> one batch dict (concatenated on dim 0, the
    DDPM chain on dim 1)."""
    return {k: torch.cat([r[k] for r in rows], dim=1 if k == "chain" else 0)
            for k in rows[0]}


class SvcPipeline:
    """A model of any family and its NSF-HiFiGAN (the vocoder of the mel
    cascades, the enhancer of the DDSP family) on one device (the CUDA card
    unless ``device`` says otherwise)."""

    def __init__(self, model_path: str, device: str | torch.device | None = None,
                 seed: int = 0, enhance: bool = False,
                 pitch_extractor: str = "yin", f0_min: float = 50.0,
                 f0_max: float = 1100.0, device_f0: bool = False,
                 vocoder_bf16: bool = False):
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
                   pitch_extractor, f0_min, f0_max, device_f0, vocoder_bf16)

    @classmethod
    def from_parts(cls, model, params, args, vocoder,
                   device: str | torch.device | None = None,
                   seed: int = 0, enhance: bool = False, units_encoder=None,
                   pitch_extractor: str = "yin", f0_min: float = 50.0,
                   f0_max: float = 1100.0, device_f0: bool = False,
                   vocoder_bf16: bool = False) -> "SvcPipeline":
        """Build a pipeline in memory: ``model`` a module of any family,
        ``params`` its state dict (None keeps the model's weights), ``args``
        the DotDict config, ``vocoder`` a Vocoder (for the DDSP family, the
        enhancer's; used when ``enhance`` is set and args has ``enhancer``),
        ``units_encoder`` a UnitsEncoder on the same device (``infer``
        needs one; ``infer_features`` does not). ``vocoder_bf16`` runs the
        NSF-HiFiGAN (the vocoder, or the DDSP family's enhancer) in bf16
        (JAX pipeline.py:87,96); the vocoder's weights are shared as they
        are, so another pipeline may serve them in f32."""
        dev = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, strict=True)
        self = cls.__new__(cls)
        self._init(model, args, vocoder, dev, seed, enhance, units_encoder,
                   pitch_extractor, f0_min, f0_max, device_f0, vocoder_bf16)
        return self

    def _init(self, model, args, vocoder, device, seed, enhance, units_encoder,
              pitch_extractor, f0_min, f0_max, device_f0, vocoder_bf16=False):
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
        # the NSF-HiFiGAN's compute type (params stay f32)
        self.vocoder_dtype = torch.bfloat16 if vocoder_bf16 else torch.float32
        if self.family != "ddsp":
            self.vocoder = vocoder.to(device).eval()
        elif enhance and args.enhancer:
            if vocoder is None:
                raise ValueError("enhance=True needs the enhancer's vocoder")
            self.enhancer = Enhancer(args.enhancer.type or "nsf-hifigan",
                                     device=device, vocoder=vocoder,
                                     dtype=self.vocoder_dtype)
        # each request's noise, when none is injected, comes from a
        # generator of its own seeded from this sequence (under a lock: the
        # HTTP server calls infer from many threads)
        self._seeds = np.random.default_rng(seed)
        self._seed_lock = threading.Lock()
        self.batcher = self.enc_batcher = None
        self._batch_sigs: set = set()
        self._batch_max_sigs = 0
        self._batch_sig_lock = threading.Lock()

    def next_seed(self) -> int:
        """The next request seed of the pipeline's sequence (thread-safe)."""
        with self._seed_lock:
            return int(self._seeds.integers(1 << 62))

    def request_generator(self, seed: int | None = None) -> torch.Generator:
        """A generator on the pipeline's device for one request: seeded with
        ``seed``, or with the next seed of the sequence."""
        return torch.Generator(device=self.device).manual_seed(
            self.next_seed() if seed is None else int(seed))

    @property
    def generator(self) -> torch.Generator:
        """A fresh per-call generator (``request_generator()``)."""
        return self.request_generator()

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
        """The f0 extractor for inputs at ``sample_rate`` (an f0 net on the
        pipeline's device, a tracker on the host)."""
        if sample_rate not in self._f0_extractors:
            self._f0_extractors[sample_rate] = F0Extractor(
                self.pitch_extractor, sample_rate, self.hop_size(sample_rate),
                self.f0_min, self.f0_max, device=self.device)
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
        enc_batcher = self.enc_batcher
        units = (enc_batcher.encode(audio, sample_rate, self.hop_size(sample_rate))
                 if enc_batcher is not None else
                 self.encode_units(on_device, sample_rate))
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
              noise: dict | None = None,
              seed: int | None = None) -> tuple[np.ndarray, int]:
        """1-D float audio at ``sample_rate`` -> (converted audio (L',) on
        the host, its sample rate). ``seed``: this request's noise seed
        (default the next of the pipeline's sequence); with batching on,
        the request's row draws its noise from it (``request_noise``).

        ``silence_front`` seconds: the mel cascades crop that many frames of
        the mel before NSF-HiFiGAN and pad the audio back with silence; with
        ``use_silence`` the whole cascade runs on the cropped frames. The
        DDSP family's enhancer skips them likewise. The sampler settings as
        ``cascade`` resolves them; ``noise`` as in ``infer_features`` (with
        the DDPM chain's ``chain``), at the frame count the model runs at."""
        hop = self.hop_size(sample_rate)
        batcher, enc_batcher = self.batcher, self.enc_batcher  # read once
        batched = batcher is not None and spk_mix_dict is None and noise is None
        seed = self.next_seed() if seed is None else int(seed)
        if (batched and self.device_f0 and enc_batcher is not None
                and enc_batcher.with_f0 and int(silence_front * sample_rate / hop) == 0):
            # the fused front end: units and f0 of the request in one
            # batched forward, padded to the frame bucket
            audio = np.asarray(audio, np.float32)
            units, f0 = enc_batcher.encode_with_f0(audio, sample_rate, hop,
                                                   key_shift)
            volume, frame_mask = self.volume_and_mask(audio, threhold, hop)
            fe = dict(units=units, f0=f0, volume=volume, frame_mask=frame_mask)
        else:
            fe = self.front_end(audio, sample_rate, key_shift, threhold,
                                silence_front)
        t = fe["volume"].shape[1]
        if batched:
            got = self._infer_batched(
                batcher, fe, t, spk_id, threhold, silence_front,
                enhancer_adaptive_key, use_silence, seed,
                dict(k_step=k_step, speedup=speedup, method=method,
                     infer_step=infer_step, t_start=t_start))
            if got is not None:
                return got
        generator = self.request_generator(seed)
        units, f0, volume = fe["units"][:, :t], fe["f0"][:, :t], fe["volume"]
        if self.family == "ddsp":
            out, out_sr = self._infer_ddsp(
                units, f0, volume, fe["frame_mask"], spk_id, noise or {},
                enhancer_adaptive_key, silence_front, spk_mix_dict, generator)
            return out[0].cpu().numpy(), out_sr
        v = self.vocoder
        start_frame = 0
        if silence_front > 0:
            start_frame = min(int(silence_front * v.vocoder_sample_rate
                                  / v.vocoder_hop_size), t - 1)
        if use_silence and start_frame > 0:
            units, f0, volume = (a[:, start_frame:] for a in (units, f0, volume))
        mel = self.cascade(units, f0, volume, spk_id, k_step, speedup, method,
                           noise, infer_step=infer_step, t_start=t_start,
                           spk_mix_dict=spk_mix_dict, generator=generator)
        if not use_silence and start_frame > 0:
            # never vocode the stale prefix
            mel, f0 = mel[:, start_frame:], f0[:, start_frame:]
        out = self.vocode(mel, f0, fe["frame_mask"], noise, start_frame,
                          generator=generator)
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
        generator = self.request_generator()
        if self.family == "ddsp":
            return self._infer_ddsp(units, f0, volume, frame_mask, spk_id,
                                    noise or {}, enhancer_adaptive_key,
                                    silence_front, spk_mix_dict, generator)
        mel = self.cascade(units, f0, volume, spk_id, k_step, speedup, method,
                           noise, infer_step=infer_step, t_start=t_start,
                           spk_mix_dict=spk_mix_dict, generator=generator)
        return (self.vocode(mel, f0, frame_mask, noise, generator=generator),
                self.vocoder.vocoder_sample_rate)

    def apply_volume_mask(self, audio, frame_mask):
        """audio (1, L) times the frame mask (T,) upsampled to samples."""
        mask = upsample(_as_tensor(frame_mask, self.device)[None, :, None],
                        int(self.args.data.block_size))[..., 0]
        return audio * mask[:, :audio.shape[-1]]

    def _infer_ddsp(self, units, f0, volume, frame_mask, spk_id, noise,
                    adaptive_key, silence_front, spk_mix_dict=None,
                    generator=None):
        """Synth -> volume mask -> enhancer (JAX: the masked direct forward,
        then ``Enhancer.enhance`` on the masked audio)."""
        audio = self.apply_volume_mask(
            self.synth_ddsp(units, f0, volume, spk_id, noise, spk_mix_dict,
                            generator=generator),
            frame_mask)
        return self.enhance(audio, f0, adaptive_key, silence_front, noise,
                            generator=generator)

    @torch.no_grad()
    def synth_ddsp(self, units, f0, volume, spk_id: int = 1,
                   noise: dict | None = None, spk_mix_dict=None,
                   model=None, generator=None) -> torch.Tensor:
        """The DDSP family's synth alone (or ``model``, a DDSP model on the
        pipeline's device): audio (B, T * block) at the model's rate,
        unmasked. ``spk_id`` an int or a (B, 1) tensor."""
        dev = self.device
        units, f0, volume = (_as_tensor(a, dev) for a in (units, f0, volume))
        audio, _ = (model or self.model)(
            units, f0, volume, spk_id=_speaker(spk_id, units.shape[0], dev),
            noise=_maybe(noise or {}, "ddsp", dev),
            generator=generator or self.generator, spk_mix_dict=spk_mix_dict)
        return audio

    @torch.no_grad()
    def enhance(self, audio, f0, adaptive_key: float | str = 0.0,
                silence_front: float = 0.0, noise: dict | None = None,
                generator=None):
        """The DDSP family's enhancer on audio at the model's rate (itself
        when the pipeline has none) -> (audio, sample rate)."""
        sr = int(self.args.data.sampling_rate)
        if self.enhancer is None:
            return audio, sr
        return self.enhancer.enhance(
            audio, sr, _as_tensor(f0, self.device), int(self.args.data.block_size),
            adaptive_key=adaptive_key, silence_front=silence_front, noise=noise,
            generator=generator or self.generator)

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
                spk_mix_dict=None, formant_shift: float = 0.0, gt_spec=None,
                generator=None):
        """The first half of ``infer_features`` for the mel cascades: the mel
        (1, T, M), with the sampler settings of ``sampler_kwargs``.
        ``formant_shift`` semitones feed the pitch-aug embedding
        (``aug_shift``); ``gt_spec`` (1, T, M), an external DDSP model's
        mel, starts a Unit2Mel shallow at k_step."""
        units, f0, volume = (_as_tensor(a, self.device) for a in (units, f0, volume))
        kwargs = self.sampler_kwargs(k_step, speedup, method, infer_step, t_start)
        return self._run_cascade(units, f0, volume, spk_id, kwargs, noise or {},
                                 generator or self.generator, spk_mix_dict,
                                 formant_shift, gt_spec)

    def _run_cascade(self, units, f0, volume, spk_id, sampler_kwargs: dict,
                     noise: dict, generator, spk_mix_dict=None,
                     formant_shift: float = 0.0, gt_spec=None):
        """The model call of ``cascade`` on device tensors with resolved
        sampler settings (the batched forward calls it at batch n)."""
        args, dev = self.args, self.device
        kwargs = dict(sampler_kwargs)
        kwargs.update(spk_id=_speaker(spk_id, units.shape[0], dev),
                      spk_mix_dict=spk_mix_dict, generator=generator,
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
               pad_frames: int = 0, dtype: torch.dtype | None = None,
               generator=None):
        """The second half: NSF-HiFiGAN on the mel (in ``dtype``, default the
        pipeline's ``vocoder_dtype``), ``pad_frames`` frames of silence in
        front, then the volume mask over the padded length (none without
        ``frame_mask``)."""
        dev = self.device
        noise = noise or {}
        n = mel.shape[1] * self.vocoder.vocoder_hop_size
        sine_kwargs = {}
        if "rand_ini" in noise:
            sine_kwargs["rand_ini"] = _maybe(noise, "rand_ini", dev)
        if "sine" in noise:
            sine_kwargs["noise"] = _maybe(noise, "sine", dev)[:, :n]
        audio = self.vocoder.infer(mel, _as_tensor(f0, dev), sine_kwargs or None,
                                   generator=generator or self.generator,
                                   dtype=dtype or self.vocoder_dtype)
        if pad_frames:
            audio = F.pad(audio, (pad_frames * self.vocoder.vocoder_hop_size, 0))
        return audio if frame_mask is None else self.apply_volume_mask(audio, frame_mask)

    # ---------------------------------------------------------- batching

    def request_noise(self, seed, frames: int) -> dict:
        """The draws one request of ``frames`` frames makes on the batched
        path, in a fixed order from a generator seeded with ``seed`` (an int
        or a torch.Generator): the DDSP stage's U(-1, 1) ``ddsp`` (1, frames
        * block); for the mel cascades the initial ``diffusion`` noise (1,
        frames, M), then the vocoder's ``rand_ini`` (1, 1, 9) and ``sine``
        (1, frames * hop, 9); for the DDSP family with its enhancer on the
        model's grid (whose chain batches whole), the enhancer's
        ``rand_ini`` and ``sine``. Handing this dict as ``noise`` to the
        direct path at the same frame count reproduces a batched row."""
        gen = (seed if isinstance(seed, torch.Generator)
               else self.request_generator(seed))
        dev, block = self.device, int(self.args.data.block_size)
        out = {}
        if self.family != "unit2mel":
            out["ddsp"] = torch.rand((1, frames * block), generator=gen,
                                     device=dev) * 2 - 1
        voc = self.vocoder
        if self.family != "ddsp":
            out["diffusion"] = torch.randn((1, frames, voc.dimension),
                                           generator=gen, device=dev)
        elif self._enhancer_batchable():
            voc = self.enhancer.vocoder
        else:
            return out
        rand_ini = torch.rand((1, 1, 9), generator=gen, device=dev)
        rand_ini[..., 0] = 0.0
        out["rand_ini"] = rand_ini
        out["sine"] = torch.randn((1, frames * voc.vocoder_hop_size, 9),
                                  generator=gen, device=dev)
        return out

    def enable_batching(self, buckets=(128, 256, 512, 1024), max_batch: int = 8,
                        max_wait_ms: float = 5.0, mesh=None,
                        max_signatures: int = 4, transfer: str = "f32",
                        transfer_in: str = "f32", pipeline_depth: int = 1,
                        batch_encoder: bool = False, audio_in: str = "f32",
                        mask_threshold: float = -60.0, **sampler):
        """Route ``infer`` through the dynamic batchers (JAX
        ``enable_batching``): concurrent requests of one frame bucket and
        one sampler signature run as one batched forward of the model at
        the right-sized row count. The mel cascades' sampler settings
        (``sampler``: k_step, speedup, method, infer_step, t_start as
        ``sampler_kwargs`` takes them) are the default signature; at most
        ``max_signatures`` distinct ones are admitted, later ones run
        direct. With ``batch_encoder`` or ``device_f0`` the units encoder
        (and with ``device_f0`` the YIN) batch too (``audio_in``: their
        upload codec). The DDSP family with an enhancer on its own grid
        runs synth, volume mask (``mask_threshold`` is its signature) and
        enhancer in one forward. ``mesh``, a sequence of devices, shards
        each batch's rows over them (JAX's ``Mesh``): every entry but the
        first runs on a replica of this pipeline (``_replica``) and, with
        the encoder batched, of its units encoder. Returns the
        ``BatchedSynth``."""
        from .batcher import BatchedSynth, mesh_devices
        from .enc_batcher import BatchedEncoder

        self.disable_batching()
        mesh = mesh_devices(mesh)
        if (batch_encoder or self.device_f0) and self.units_encoder is not None:
            self.enc_batcher = BatchedEncoder(
                self.units_encoder, frame_buckets=buckets, max_batch=max_batch,
                max_wait_ms=max_wait_ms, with_f0=self.device_f0,
                f0_min=self.f0_min, f0_max=self.f0_max, transfer_in=audio_in,
                mesh=mesh)
        out_hop = None
        self._batch_max_sigs = max_signatures
        if self.family == "ddsp":
            if self._enhancer_batchable():
                self._batch_sigs = {(("mask_threshold", float(mask_threshold)),)}
                out_hop = self.enhancer.vocoder.vocoder_hop_size
            else:
                self._batch_sigs = {()}
            builder = "_ddsp_builder"
        else:
            self._batch_sigs = {self._static_sig(self.sampler_kwargs(**sampler))}
            builder = "_cascade_builder"
            out_hop = self.vocoder.vocoder_hop_size
        if mesh is None:
            builders = getattr(self, builder)
        else:  # entry d's block runs on its own replica of this pipeline
            own = mesh_devices([self.device])[0]
            builders = [getattr(self if d == 0 and dev == own
                                else self._replica(dev), builder)
                        for d, dev in enumerate(mesh)]
        self.batcher = BatchedSynth(
            self.model, buckets=buckets, max_batch=max_batch,
            max_wait_ms=max_wait_ms, mesh=mesh, forward_builder=builders,
            out_hop=out_hop or int(self.args.data.block_size),
            transfer=transfer, transfer_in=transfer_in,
            pipeline_depth=pipeline_depth, device=self.device)
        return self.batcher

    def _replica(self, device: torch.device) -> "SvcPipeline":
        """This pipeline for one mesh entry on ``device``: its own copy of
        the model and of the NSF-HiFiGAN (vocoder or enhancer), no units
        encoder and no batchers; the batched forward's builders run on it."""
        from ..models.vocoder import Enhancer

        rep = copy.copy(self)
        rep.device = device
        rep.model = copy.deepcopy(self.model).to(device).eval()
        if self.vocoder is not None:
            rep.vocoder = copy.deepcopy(self.vocoder).to(device).eval()
        if self.enhancer is not None:
            rep.enhancer = Enhancer(
                self.args.enhancer.type or "nsf-hifigan", device=device,
                vocoder=copy.deepcopy(self.enhancer.vocoder).to(device).eval(),
                dtype=self.vocoder_dtype)
        rep.units_encoder = rep.batcher = rep.enc_batcher = None
        rep._f0_extractors, rep._f0_fns = {}, {}
        return rep

    def _enhancer_batchable(self) -> bool:
        """Whether the DDSP family's enhancer runs on the model's own grid
        (rate and hop), so the whole chain fits one batched forward."""
        ev = self.enhancer.vocoder if self.enhancer is not None else None
        return ev is not None and (
            ev.vocoder_sample_rate == int(self.args.data.sampling_rate)
            and ev.vocoder_hop_size == int(self.args.data.block_size))

    def disable_batching(self) -> None:
        """Close the batchers (queued requests fail); ``infer`` runs direct."""
        for eng in (self.batcher, self.enc_batcher):
            if eng is not None:
                eng.close()
        self.batcher = self.enc_batcher = None

    def warmup_batching(self, traffic_drill: bool = True, **infer_kwargs) -> None:
        """Run every bucket once before traffic arrives (``--warmup``) under
        the default signature, and with ``traffic_drill`` max_batch
        concurrent silent requests and one alone through the whole
        ``infer``; then zero the batchers' stats."""
        if self.batcher is None:
            raise RuntimeError("enable_batching() first")
        with self._batch_sig_lock:
            sig = next(iter(self._batch_sigs))
        self.batcher.warmup(int(self.args.data.encoder_out_channels), sig)
        sr, block = int(self.args.data.sampling_rate), int(self.args.data.block_size)
        if self.enc_batcher is not None:
            self.enc_batcher.warmup(sr, block)
        if not traffic_drill:
            return
        if not infer_kwargs and sig:
            names = {"infer_speedup": "speedup", "sampler": "method",
                     "mask_threshold": "threhold"}
            infer_kwargs = {names.get(k, k): v for k, v in sig}
        audio = np.zeros((min(self.batcher.buckets) - 1) * block, np.float32)
        errors = []

        def one():
            try:
                self.infer(audio, sr, spk_id=1, **infer_kwargs)
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=one) for _ in range(self.batcher.max_batch)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        one()
        if errors:
            raise errors[0]
        self.batcher.reset_stats()
        if self.enc_batcher is not None:
            self.enc_batcher.reset_stats()

    @staticmethod
    def _static_sig(sampler_kwargs: dict) -> tuple:
        """A request's batching signature: its resolved sampler settings."""
        return tuple(sorted(sampler_kwargs.items()))

    def _admit_sig(self, sig: tuple) -> bool:
        """Admit a signature to the batched path, at most
        ``max_signatures`` distinct ones; the rest run direct."""
        with self._batch_sig_lock:
            if sig in self._batch_sigs:
                return True
            if len(self._batch_sigs) < self._batch_max_sigs:
                self._batch_sigs.add(sig)
                return True
        return False

    def _ddsp_builder(self, bucket: int, sig: tuple):
        """The DDSP family's batched forward: the synth, and with the
        enhancer in the batch (JAX pipeline.py:176-270) the volume gate
        with each row's live frames, the mel, and the enhancer's generator
        on the live rows; every row's draws from its own generator."""
        block = int(self.args.data.block_size)
        gate = 10.0 ** (dict(sig)["mask_threshold"] / 20.0) if sig else None

        def fwd(units, f0, volume, spk, generators, tframes):
            noise = _cat_noise([self.request_noise(g, bucket) for g in generators])
            audio, _ = self.model(units, f0, volume, spk_id=spk,
                                  noise=noise["ddsp"])
            if gate is None:
                return audio
            live = (torch.arange(bucket, device=units.device)
                    < tframes[:, None]).float()
            m = get_mask_batch(volume[..., 0], gate) * live
            m = upsample(m[..., None], block)[..., 0]
            audio = audio * m[:, :audio.shape[-1]]
            ev = self.enhancer.vocoder
            mel = ev.extract(audio)
            mel = mel * live[:, :mel.shape[1], None]
            f0g = f0[:, :mel.shape[1], 0] * live[:, :mel.shape[1]]
            n = mel.shape[1] * ev.vocoder_hop_size
            return ev.infer(mel, f0g, dict(rand_ini=noise["rand_ini"],
                                           noise=noise["sine"][:, :n]),
                            dtype=self.vocoder_dtype)

        return fwd

    def _cascade_builder(self, bucket: int, sig: tuple):
        """A mel cascade's batched forward (JAX pipeline.py:272-328): the
        cascade at the signature's sampler settings, the mel rows and the
        f0 beyond each row's real frames zeroed, then the vocoder; every
        row's draws from its own generator."""
        kw = dict(sig)

        def fwd(units, f0, volume, spk, generators, tframes):
            noise = _cat_noise([self.request_noise(g, bucket) for g in generators])
            mel = self._run_cascade(units, f0, volume, spk, kw, noise, None)
            live = (torch.arange(bucket, device=units.device)
                    < tframes[:, None]).float()
            mel = mel * live[..., None]
            return self.vocoder.infer(mel, f0[..., 0] * live,
                                      dict(rand_ini=noise["rand_ini"],
                                           noise=noise["sine"]),
                                      dtype=self.vocoder_dtype)

        return fwd

    def _infer_batched(self, batcher, fe: dict, t: int, spk_id, threhold,
                       silence_front, adaptive_key, use_silence, seed,
                       sampler: dict):
        """``infer``'s batched branches (JAX pipeline.py:526-760) -> (audio
        on the host, its rate), or None for the direct path: a request
        longer than the largest bucket, a signature not admitted, the DDPM
        chain, or the in-batch enhancer with an adaptive key or a silent
        prefix."""
        if t > batcher.buckets[-1]:
            return None
        units, f0, volume = fe["units"], fe["f0"], fe["volume"]
        if isinstance(units, torch.Tensor) and not isinstance(f0, torch.Tensor):
            f0 = torch.from_numpy(np.asarray(f0, np.float32)).to(self.device)
        block = int(self.args.data.block_size)
        mask = upsample(torch.as_tensor(fe["frame_mask"], dtype=torch.float32)
                        [None, :, None], block)[0, :, 0].numpy()
        if self.family == "ddsp":
            if self._enhancer_batchable():
                sig = (("mask_threshold", float(threhold)),)
                if (adaptive_key not in (0, 0.0) or silence_front != 0.0
                        or not self._admit_sig(sig)):
                    return None
                out = batcher.infer(units[0], f0[0], volume[0], spk_id, seed,
                                    sig=sig, n_frames=t)
                return out, self.enhancer.vocoder.vocoder_sample_rate
            out = batcher.infer(units[0], f0[0], volume[0], spk_id, seed,
                                sig=(), n_frames=t)
            out = out * mask[:out.shape[-1]]
            if self.enhancer is None:
                return out, int(self.args.data.sampling_rate)
            audio = torch.from_numpy(out)[None].to(self.device)
            enh, sr = self.enhance(audio, f0[:, :t], adaptive_key, silence_front,
                                   generator=self.request_generator(seed))
            return enh[0].cpu().numpy(), sr
        kw = self.sampler_kwargs(**sampler)
        if self.family != "reflow" and int(kw["infer_speedup"]) <= 1:
            return None  # the DDPM chain draws per step: it runs direct
        v = self.vocoder
        start_frame = 0
        if use_silence and silence_front > 0:
            start_frame = min(int(silence_front * v.vocoder_sample_rate
                                  / v.vocoder_hop_size), t - 1)
            units, f0, volume = (a[:, start_frame:] for a in (units, f0, volume))
            t -= start_frame
        sig = self._static_sig(kw)
        if not self._admit_sig(sig):
            return None
        out = batcher.infer(units[0], f0[0], volume[0], spk_id, seed, sig=sig,
                            n_frames=t)
        if start_frame:
            out = np.pad(out, (start_frame * v.vocoder_hop_size, 0))
        return out * mask[:out.shape[-1]], v.vocoder_sample_rate
