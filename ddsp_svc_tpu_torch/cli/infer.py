"""Offline voice-conversion CLI for every model family (mirrors
ddsp_svc_tpu/cli/infer.py).

python -m ddsp_svc_tpu_torch.cli.infer -m exp/model_10000.ckpt -i in.wav \\
    -o out.wav [-k 0] [-id 1] [-mix "{1: 0.5, 2: 0.5}"] [-th -60] [-pe yin] \\
    [-kstep 100] [-method dpm-solver] [-speedup 10] [-step 20] [-ts 0.7] \\
    [-fs 0] [-ddsp exp/ddsp/model_N.ckpt] [-e true -eak 0] [--device cpu]

The f0 of the whole input is cached under ``cache/`` beside the output,
keyed by the input's MD5 (the JAX CLI's file name and .npy content, so
either CLI reads the other's cache); then the key shift, the volume mask
with its 9-frame dilation, the silence split, one conversion per segment,
and the zero-fill / linear cross-fade splice. ``main`` reads the checkpoint
(which needs PyYAML and msgpack) and the wav; ``convert`` is the conversion
on a pipeline in memory. ``--voc_bf16`` runs the mel cascades' NSF-HiFiGAN
in bf16, as the JAX CLI does (cli/infer.py:62,134; the DDSP family's
enhancer stays f32 there).

``--stream N`` (the DDSP families; the others ignore it, as the JAX CLI
does, cli/infer.py:79-80,172-216) synthesises each segment time-sharded
over N ranks (``parallel/``): this process is rank 0 (the front end, the
splice and the enhancer) and starts N - 1 helper ranks once per run, on
the card (rank r on ``cuda:{r % cards}``) or, with ``--device cpu``, on the
CPU. A segment is padded as the JAX CLI pads it (to a multiple of N and at
least N (FRAME_HALO + 8) frames, the real f0 and volume that follow it
first, then its last frame repeated) and its tail trimmed after; its last
FRAME_HALO frames may differ from the unstreamed output, which has its own
edge there. ``-mix`` with ``--stream`` is refused with the JAX CLI's words.
"""
from __future__ import annotations

import argparse
import hashlib
import os
from ast import literal_eval

import numpy as np
import torch

from ..features.audio import load_wav, save_wav
from ..features.f0 import F0Extractor
from ..features.slicer import split_audio
from ..ops.interp import upsample

# the JAX CLI's refusal (cli/infer.py:197-201), word for word
STREAM_MIX_REFUSED = ("-mix is not supported with --stream: the streamed "
                      "engines take a single spk_id (drop --stream or use -id)")


def cross_fade(a: np.ndarray, b: np.ndarray, idx: int) -> np.ndarray:
    """Linear cross-fade splice of ``b`` onto ``a`` from sample ``idx``."""
    result = np.zeros(idx + b.shape[0])
    fade_len = a.shape[0] - idx
    result[:idx] = a[:idx]
    k = np.linspace(0, 1.0, num=fade_len, endpoint=True)
    result[idx: a.shape[0]] = (1 - k) * a[idx:] + k * b[:fade_len]
    result[a.shape[0]:] = b[fade_len:]
    return result


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ddsp_svc_tpu_torch.cli.infer",
        description="Convert a wav with a checkpoint of the JAX package, of "
                    "any model family, on the CUDA card (or --device cpu).")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-ddsp", "--ddsp_model_path", default=None)
    p.add_argument("-id", "--spk_id", type=int, default=1)
    p.add_argument("-mix", "--spk_mix_dict", default="None")
    p.add_argument("-diffid", "--diff_spk_id", default="auto")
    p.add_argument("-k", "--key", type=float, default=0.0)
    p.add_argument("-e", "--enhance", default="true")
    p.add_argument("--voc_bf16", action="store_true",
                   help="run the mel cascades' NSF-HiFiGAN vocoder in bf16")
    p.add_argument("-pe", "--pitch_extractor", default="yin")
    p.add_argument("-fmin", "--f0_min", type=float, default=50.0)
    p.add_argument("-fmax", "--f0_max", type=float, default=1100.0)
    p.add_argument("-th", "--threhold", type=float, default=-60.0)
    p.add_argument("-eak", "--enhancer_adaptive_key", default="0")
    p.add_argument("-fs", "--formant_shift_key", type=float, default=0.0)
    p.add_argument("-kstep", "--k_step", type=int, default=None)
    p.add_argument("-speedup", "--speedup", type=int, default=10)
    p.add_argument("-method", "--method", default=None)
    p.add_argument("-step", "--infer_step", type=int, default=None)
    p.add_argument("-ts", "--t_start", type=float, default=None)
    p.add_argument("--stream", type=int, default=0, metavar="N_DEVICES")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def streams(options: argparse.Namespace, family: str) -> bool:
    """Whether ``--stream`` applies: N > 1 on a DDSP family."""
    return options.stream > 1 and family == "ddsp"


def check_ported(options: argparse.Namespace, family: str = "ddsp") -> None:
    """Refuse what the JAX CLI refuses: ``-mix`` with ``--stream`` on a
    DDSP family (the streamed engines take one speaker)."""
    if streams(options, family) and literal_eval(options.spk_mix_dict) is not None:
        raise NotImplementedError(STREAM_MIX_REFUSED)


def stream_segment(world, pipeline, seg_units, f0, volume, start_frame: int,
                   spk_id: int) -> torch.Tensor:
    """One segment's DDSP synthesis time-sharded over ``world``'s ranks,
    padded as the JAX CLI pads it: units (1, t, C) on the pipeline's
    device, the whole input's f0 and volume (1, T, 1) -> (1, t * block)."""
    from ..parallel.stream import FRAME_HALO, streamed_forward

    n = world.size
    t_seg = seg_units.shape[1]
    pad_t = (-t_seg) % n
    min_t = n * (FRAME_HALO + 8)
    if t_seg + pad_t < min_t:  # a short segment: pad up to the halo minimum
        pad_t = min_t - t_seg
        pad_t += (-(t_seg + pad_t)) % n
    # f0 and volume exist past the segment: take the real frames first,
    # then repeat the last; units repeat their last frame
    ext = min(pad_t, f0.shape[1] - (start_frame + t_seg))
    syn = pad_t - ext
    end = start_frame + t_seg + ext
    dev = pipeline.device

    def edge_pad(x, n_pad):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return torch.cat([x, x[:, -1:].expand(-1, n_pad, -1)], dim=1)

    out = world.call(
        streamed_forward, pipeline.model, edge_pad(seg_units, pad_t),
        edge_pad(f0[:, start_frame:end], syn),
        edge_pad(volume[:, start_frame:end], syn),
        spk_id=torch.full((1, 1), int(spk_id), dtype=torch.long, device=dev),
        generator=pipeline.generator)
    return out[:, :t_seg * int(pipeline.args.data.block_size)]


def cached_f0(options: argparse.Namespace, audio: np.ndarray, sample_rate: int,
              hop_size: int, device: str | torch.device | None = None
              ) -> np.ndarray:
    """The input's f0 (uv-interpolated, no key shift), read from or written
    to the MD5-keyed cache beside the output; an f0 net runs on
    ``device``."""
    with open(options.input, "rb") as f:
        md5_hash = hashlib.md5(f.read()).hexdigest()
    cache_dir = os.path.join(os.path.dirname(options.output) or ".", "cache")
    cache_file = os.path.join(
        cache_dir, f"{options.pitch_extractor}_{hop_size}_{options.f0_min}_"
                   f"{options.f0_max}_{md5_hash}.npy")
    if os.path.exists(cache_file):
        return np.load(cache_file)
    f0 = F0Extractor(options.pitch_extractor, sample_rate, hop_size,
                     options.f0_min, options.f0_max,
                     device=device).extract(audio, uv_interp=True)
    os.makedirs(cache_dir, exist_ok=True)
    np.save(cache_file, f0)
    return f0


@torch.no_grad()
def convert(pipeline, audio: np.ndarray, sample_rate: int,
            options: argparse.Namespace, f0: np.ndarray | None = None,
            ddsp_model=None) -> tuple[np.ndarray, int]:
    """The CLI's conversion of a 1-D recording at ``sample_rate`` on a
    ``SvcPipeline`` (``_convert``); with ``--stream N`` on a DDSP family,
    inside a world of N ranks started for the call."""
    check_ported(options, pipeline.family)
    if not streams(options, pipeline.family):
        return _convert(pipeline, audio, sample_rate, options, f0, ddsp_model)
    from ..parallel.mesh import World

    with World(options.stream, device=pipeline.device) as world:
        return _convert(pipeline, audio, sample_rate, options, f0, ddsp_model,
                        world)


def _convert(pipeline, audio: np.ndarray, sample_rate: int,
             options: argparse.Namespace, f0: np.ndarray | None = None,
             ddsp_model=None, world=None) -> tuple[np.ndarray, int]:
    """The CLI's conversion of a 1-D recording at ``sample_rate`` on a
    ``SvcPipeline`` -> (audio (L',) float64 on the host, its sample rate).
    ``options`` are ``parse_args``'s; ``f0`` (T,) the input's f0 before the
    key shift (the pipeline's host tracker when not given); ``ddsp_model``
    the external DDSP model of ``-ddsp`` on the pipeline's device, whose
    mel (f0 lowered and the mel's keyshift raised by ``-fs``) starts a
    Diffusion (Unit2Mel) model shallow at k_step; ``world`` the ranks of
    ``--stream``."""
    args = pipeline.args
    block = int(args.data.block_size)
    model_sr = int(args.data.sampling_rate)
    hop_size = pipeline.hop_size(sample_rate)
    if f0 is None:
        f0 = pipeline.f0_extractor(sample_rate).extract(audio, uv_interp=True)
    f0 = np.asarray(f0, np.float32)[None, :, None] * np.float32(
        2 ** (options.key / 12.0))
    volume, frame_mask = pipeline.volume_and_mask(audio, options.threhold, hop_size)
    mask = upsample(torch.as_tensor(frame_mask, dtype=torch.float32,
                                    device=pipeline.device)[None, :, None],
                    block)[..., 0]
    adaptive_key = (options.enhancer_adaptive_key
                    if options.enhancer_adaptive_key == "auto"
                    else float(options.enhancer_adaptive_key))
    infer_cfg = args.infer or {}
    spk_mix_dict = literal_eval(options.spk_mix_dict)
    diff_spk_id = (options.spk_id if options.diff_spk_id == "auto"
                   else int(options.diff_spk_id))
    fs = options.formant_shift_key
    t_start = None
    if pipeline.family == "reflow":
        t_start = float(args.model.t_start or 0.0)
        if options.t_start is not None:
            t_start = max(options.t_start, t_start)
    sampler = dict(k_step=options.k_step, speedup=options.speedup,
                   method=options.method or infer_cfg.get("method"),
                   infer_step=(options.infer_step or infer_cfg.get("infer_step")
                               or 20),
                   t_start=t_start)

    segments = split_audio(audio, sample_rate)
    print(f"Cut the input audio into {len(segments)} slices")
    result = np.zeros(0)
    current_length = 0
    out_sr = model_sr
    for start_sample, seg in segments:
        start_frame = start_sample // hop_size
        seg_units = pipeline.encode_units(seg, sample_rate)
        t_seg = seg_units.shape[1]
        seg_f0 = f0[:, start_frame: start_frame + t_seg]
        seg_volume = volume[:, start_frame: start_frame + t_seg]
        if pipeline.family == "ddsp" and world is not None:
            seg_out = stream_segment(world, pipeline, seg_units, f0, volume,
                                     start_frame, options.spk_id)
            out_sr = model_sr
        elif pipeline.family == "ddsp":
            seg_out = pipeline.synth_ddsp(seg_units, seg_f0, seg_volume,
                                          options.spk_id,
                                          spk_mix_dict=spk_mix_dict)
            out_sr = model_sr
        else:
            gt_spec = None
            if ddsp_model is not None:
                ddsp_out = pipeline.synth_ddsp(
                    seg_units, 2 ** (-fs / 12.0) * seg_f0, seg_volume,
                    options.spk_id, spk_mix_dict=spk_mix_dict, model=ddsp_model)
                gt_spec = pipeline.vocoder.extract(ddsp_out, model_sr, keyshift=fs)
            mel = pipeline.cascade(seg_units, seg_f0, seg_volume, diff_spk_id,
                                   spk_mix_dict=spk_mix_dict, formant_shift=fs,
                                   gt_spec=gt_spec, **sampler)
            seg_out = pipeline.vocode(
                mel, seg_f0, dtype=torch.bfloat16 if options.voc_bf16 else None)
            out_sr = pipeline.vocoder.vocoder_sample_rate
        seg_out = seg_out * mask[:, start_frame * block:
                                 start_frame * block + seg_out.shape[-1]]
        if pipeline.enhancer is not None:
            seg_out, out_sr = pipeline.enhance(seg_out, seg_f0, adaptive_key)
        seg_np = seg_out[0].cpu().numpy()

        silent_length = (round(start_frame * block * out_sr / model_sr)
                         - current_length)
        if silent_length >= 0:
            result = np.append(result, np.zeros(silent_length))
            result = np.append(result, seg_np)
        else:
            result = cross_fade(result, seg_np, current_length + silent_length)
        current_length = current_length + silent_length + len(seg_np)
    return result, out_sr


def load_ddsp_model(path: str, pipeline):
    """The ``-ddsp`` model on the pipeline's device, its config checked
    against the pipeline's (the rate, the hop and the encoder)."""
    from ..models.registry import load_model

    model, ddsp_args = load_model(path, device=pipeline.device)
    for key in ("sampling_rate", "block_size", "encoder"):
        if ddsp_args.data[key] != pipeline.args.data[key]:
            raise ValueError(f"-ddsp: the DDSP model's data.{key} "
                             f"{ddsp_args.data[key]!r} differs from the "
                             f"model's {pipeline.args.data[key]!r}")
    return model.eval()


def main(argv=None) -> None:
    from ..infer.pipeline import SvcPipeline

    options = parse_args(argv)
    pipeline = SvcPipeline(options.model_path, device=options.device,
                           enhance=options.enhance == "true",
                           pitch_extractor=options.pitch_extractor,
                           f0_min=options.f0_min, f0_max=options.f0_max)
    ddsp_model = (load_ddsp_model(options.ddsp_model_path, pipeline)
                  if options.ddsp_model_path else None)
    audio, sample_rate = load_wav(options.input)
    f0 = cached_f0(options, audio, sample_rate, pipeline.hop_size(sample_rate),
                   pipeline.device)
    result, out_sr = convert(pipeline, audio, sample_rate, options, f0,
                             ddsp_model)
    save_wav(options.output, result.astype(np.float32), out_sr)
    print(f"Saved: {options.output} ({len(result) / out_sr:.2f}s)")


if __name__ == "__main__":
    main()
