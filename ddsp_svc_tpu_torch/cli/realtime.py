"""Realtime voice-conversion CLI (mirrors ddsp_svc_tpu/cli/realtime.py):
the block engine of ``infer/realtime.py`` on the CUDA card (or
``--device cpu``).

File mode drives the realtime block engine over a recording:
  python -m ddsp_svc_tpu_torch.cli.realtime -m exp/model_N.ckpt -i in.wav -o out.wav

Live mode needs the optional ``sounddevice`` package, imported only then:
  python -m ddsp_svc_tpu_torch.cli.realtime -m exp/model_N.ckpt --live

``--voc_bf16`` runs the NSF-HiFiGAN (the vocoder, or the DDSP family's
enhancer) in bf16, as the JAX CLI's pipeline does (cli/realtime.py:35,53).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ddsp_svc_tpu_torch.cli.realtime",
        description="Realtime voice conversion with a checkpoint of the JAX "
                    "package, on the CUDA card (or --device cpu): a wav file "
                    "through the block engine, or --live audio.")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-i", "--input")
    p.add_argument("-o", "--output")
    p.add_argument("--live", action="store_true")
    p.add_argument("-id", "--spk_id", type=int, default=1)
    p.add_argument("-k", "--key", type=float, default=0.0)
    p.add_argument("-th", "--threhold", type=float, default=-45.0)
    p.add_argument("-pe", "--pitch_extractor", default="yin")
    p.add_argument("--block_time", type=float, default=0.3)
    p.add_argument("--crossfade_time", type=float, default=0.04)
    p.add_argument("--extra_time", type=float, default=2.0)
    p.add_argument("--phase_vocoder", action="store_true")
    p.add_argument("--diff_silence", action="store_true",
                   help="mel cascades: run the cascade on the fresh frames "
                        "only (the pipeline's use_silence)")
    p.add_argument("--voc_bf16", action="store_true",
                   help="run the NSF-HiFiGAN (vocoder or enhancer) in bf16")
    p.add_argument("--device_f0", action="store_true",
                   help="the YIN f0 on the card (yin extractor only)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def run_file(vc, input_path: str, output_path: str) -> dict:
    """A wav through ``drive_blocks`` at the engine's rate, written as
    PCM16 -> drive_blocks's stats."""
    from ..features.audio import load_wav, save_wav
    from ..infer.realtime import drive_blocks
    from ..ops.resample import resample

    audio, in_sr = load_wav(input_path)
    if in_sr != vc.sr:
        audio = resample(torch.as_tensor(audio, device=vc.pipeline.device)[None],
                         in_sr, vc.sr)[0].cpu().numpy()
    out, stats = drive_blocks(vc, audio.astype(np.float32))
    save_wav(output_path, out, vc.sr)
    steady = stats["times_s"][2:] or stats["times_s"]
    print(f"Saved: {output_path} ({len(out) / vc.sr:.2f}s, {stats['blocks']} "
          f"blocks; block {vc.block_frame / vc.sr * 1e3:.0f} ms, infer mean "
          f"{stats['block_ms']:.1f} ms, max {np.max(steady) * 1e3:.1f} ms)")
    return stats


def main(argv=None) -> None:
    from ..infer.pipeline import SvcPipeline
    from ..infer.realtime import RealtimeVC

    cmd = parse_args(argv)
    if not cmd.live and not (cmd.input and cmd.output):
        raise SystemExit("file mode needs -i and -o (or --live)")
    pipeline = SvcPipeline(cmd.model_path, device=cmd.device,
                           pitch_extractor=cmd.pitch_extractor,
                           device_f0=cmd.device_f0, vocoder_bf16=cmd.voc_bf16)
    sr = pipeline.args.data.sampling_rate
    vc = RealtimeVC(pipeline, sample_rate=sr, block_time=cmd.block_time,
                    crossfade_time=cmd.crossfade_time, extra_time=cmd.extra_time,
                    use_phase_vocoder=cmd.phase_vocoder, spk_id=cmd.spk_id,
                    key_shift=cmd.key, threhold=cmd.threhold,
                    use_silence=cmd.diff_silence)
    if not cmd.live:
        run_file(vc, cmd.input, cmd.output)
        return
    import sounddevice as sd  # optional: only live mode needs it

    def callback(indata, outdata, frames, time_info, status):
        outdata[:, 0] = vc.process_block(indata[:, 0].astype(np.float32))

    with sd.Stream(samplerate=sr, blocksize=vc.block_frame, channels=1,
                   callback=callback):
        print("realtime VC running - Ctrl-C to stop")
        while True:
            time.sleep(1)


if __name__ == "__main__":
    main()
