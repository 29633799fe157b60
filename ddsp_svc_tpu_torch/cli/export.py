"""Model export (mirrors ddsp_svc_tpu/cli/export.py): the inference
forward of a checkpointed model as a ``torch.export`` program, written with
``torch.export.save`` (a ``.pt2``), reloadable in a fresh process with
``load_exported``.

python -m ddsp_svc_tpu_torch.cli.export -m exp/model_10000.ckpt -o model.pt2 \\
    [--seconds 2.0] [--graph model.graph.txt] [-kstep 100] [--device cpu]

The three branches of the JAX export, at a fixed t = seconds * sr //
block_size frames: the DDSP family returns the signal (1, t * block);
Unit2Mel (type Diffusion) takes the mel it starts shallow from, ``gt_spec``
(1, t, 128), as a real input; the cascades carry their mel extractor inside
the graph and return the mel. The sampler settings are the models'
defaults, as in the JAX export (Unit2Mel k_step 300, DiffusionNew and
DiffusionFast no diffusion unless ``-kstep`` is given, RectifiedFlow 10
euler steps), each at speedup 10 with 'dpm-solver' where it diffuses.

The one interface difference from JAX: the JAX exported function takes a
PRNG key, and a ``torch.export`` program cannot reproduce JAX's Threefry
draws, so the port's program takes the draws themselves as inputs -- the
DDSP synths' ``noise`` (1, t * block), the cascades' ``ddsp_noise`` (1, t *
block) and ``init_noise`` (1, t, 128) -- in the order the artifact's
metadata lists them. ``load_exported(path, device, seed)`` draws them from
a seeded ``torch.Generator`` (on the CPU, then moved, so every device gets
the same draws).

K1, K3 and K4 are registered operators (``torch.ops.ddsp_svc.*``,
``ops/kernels.OPS``), so the graph holds one node per kernel call: on the
card it launches the hand-written kernel, on the CPU its plain version, an
artifact exported from CPU inputs as well as one exported on the card.
``load_exported`` imports the registrations before ``torch.export.load``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.nn as nn

META = "ddsp_svc_export.json"  # the artifact's metadata (extra file)


def _register_ops() -> None:
    """Import the kernels' operator registrations (a fresh process needs
    them before ``torch.export.load``)."""
    from ..ops import cuda_conformer, cuda_oscillator, cuda_source  # noqa: F401


class DdspForward(nn.Module):
    """The DDSP family: the signal (1, t * block) from the synth noise."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, units, f0, volume, spk_id, noise):
        return self.model(units, f0, volume, spk_id=spk_id, noise=noise)[0]


class Unit2MelForward(nn.Module):
    """Unit2Mel: the mel from ``gt_spec`` at k_step (JAX default 300)."""

    def __init__(self, model: nn.Module, k_step: int = 300):
        super().__init__()
        self.model, self.k_step = model, k_step

    def forward(self, units, f0, volume, spk_id, gt_spec, init_noise):
        return self.model(units, f0, volume, spk_id=spk_id, gt_spec=gt_spec,
                          k_step=self.k_step, init_noise=init_noise)


class CascadeForward(nn.Module):
    """DiffusionNew, DiffusionFast and RectifiedFlow: the DDSP stage, its
    mel through the vocoder's mel extractor (inside the graph, so the
    denoiser never samples around a mel that is not the synth's), then the
    diffusion or the ODE."""

    def __init__(self, model: nn.Module, mel_extractor: nn.Module,
                 sampler_kwargs: dict):
        super().__init__()
        self.model, self.mel = model, mel_extractor
        self.sampler_kwargs = dict(sampler_kwargs)

    def forward(self, units, f0, volume, spk_id, ddsp_noise, init_noise):
        return self.model(units, f0, volume, spk_id=spk_id,
                          mel_extract_fn=self.mel.extract,
                          ddsp_noise=ddsp_noise, init_noise=init_noise,
                          **self.sampler_kwargs)


def build_forward(model: nn.Module, args, k_step: int | None = None,
                  device: str | torch.device = "cpu"
                  ) -> tuple[nn.Module, dict]:
    """(the module to export, its metadata) for a model of any family at
    ``args``' rate and hop. The metadata names the inputs in order and the
    draws among them, each with its distribution."""
    from ..models.registry import model_family
    from .common import build_mel_extractor

    mtype, family = args.model.type, model_family(args.model.type)
    block, m = int(args.data.block_size), int(args.model.out_dims or 128)
    meta = {"type": mtype, "family": family,
            "sampling_rate": int(args.data.sampling_rate), "block_size": block,
            "n_unit": int(args.data.encoder_out_channels), "n_mels": m}
    if family == "ddsp":
        module = DdspForward(model)
        meta["draws"] = {"noise": ["samples", type(model).NOISE]}
    elif mtype == "Diffusion":
        module = Unit2MelForward(model, 300 if k_step is None else k_step)
        meta["draws"] = {"init_noise": ["mel", "normal"]}
    else:
        if family == "reflow":
            kwargs = {}
        else:
            kwargs = {"k_step": k_step}
        module = CascadeForward(model, build_mel_extractor(args, device), kwargs)
        meta["draws"] = {"ddsp_noise": ["samples", type(model.ddsp_model).NOISE],
                         "init_noise": ["mel", "normal"]}
    meta["inputs"] = (["units", "f0", "volume", "spk_id"]
                      + (["gt_spec"] if mtype == "Diffusion" else [])
                      + list(meta["draws"]))
    return module.eval(), meta


def input_shapes(meta: dict, frames: int) -> dict:
    """Each input's shape and dtype at ``frames`` frames."""
    samples, mel = (1, frames * meta["block_size"]), (1, frames, meta["n_mels"])
    shapes = {"units": ((1, frames, meta["n_unit"]), torch.float32),
              "f0": ((1, frames, 1), torch.float32),
              "volume": ((1, frames, 1), torch.float32),
              "spk_id": ((1, 1), torch.int32),
              "gt_spec": (mel, torch.float32)}
    for name, (kind, _) in meta["draws"].items():
        shapes[name] = ((samples if kind == "samples" else mel), torch.float32)
    return shapes


def draw(meta: dict, frames: int, generator: torch.Generator,
         device: str | torch.device) -> dict:
    """The program's draws at ``frames`` frames from ``generator`` (a CPU
    generator: the same draws on every device), on ``device``."""
    shapes = input_shapes(meta, frames)
    out = {}
    for name, (_, dist) in meta["draws"].items():
        shape, dtype = shapes[name]
        if dist == "normal":
            t = torch.randn(shape, generator=generator, dtype=dtype)
        else:
            t = torch.rand(shape, generator=generator, dtype=dtype) * 2.0 - 1.0
        out[name] = t.to(device)
    return out


def example_inputs(meta: dict, frames: int, device) -> tuple:
    """Inputs to trace with: f0 at 220 Hz, the rest zeros or ones (the
    program is traced at these shapes; the values do not matter)."""
    shapes = input_shapes(meta, frames)
    fill = {"f0": 220.0, "volume": 1.0, "spk_id": 1}
    return tuple(torch.full(shapes[n][0], fill.get(n, 0.0), dtype=shapes[n][1],
                            device=device) for n in meta["inputs"])


def export_model(model: nn.Module, args, frames: int, k_step: int | None = None,
                 device: str | torch.device = "cpu"):
    """-> (ExportedProgram, metadata) of ``model`` (on ``device``) at
    ``frames`` frames."""
    _register_ops()
    module, meta = build_forward(model, args, k_step, device)
    meta["frames"] = frames
    with torch.no_grad():
        program = torch.export.export(module, example_inputs(meta, frames, device))
    return program, meta


class ExportedModel:
    """A loaded artifact on one device: call it with the model inputs (and
    ``gt_spec`` for Unit2Mel); the draws come from its seeded generator
    unless passed as keywords."""

    def __init__(self, module: nn.Module, meta: dict, device, seed: int):
        self.module, self.meta, self.device = module, meta, torch.device(device)
        self.generator = torch.Generator().manual_seed(seed)

    def __call__(self, units, f0, volume, spk_id=None, gt_spec=None, **draws):
        frames = units.shape[1]
        if spk_id is None:
            spk_id = torch.ones((1, 1), dtype=torch.int32, device=self.device)
        given = {"units": units, "f0": f0, "volume": volume, "spk_id": spk_id,
                 "gt_spec": gt_spec}
        missing = [n for n in self.meta["draws"] if n not in draws]
        if missing:
            drawn = draw(self.meta, frames, self.generator, self.device)
            draws = {**{n: drawn[n] for n in missing}, **draws}
        given.update(draws)
        with torch.no_grad():
            return self.module(*(given[n] for n in self.meta["inputs"]))


def load_exported(path: str, device: str | torch.device | None = None,
                  seed: int = 0) -> ExportedModel:
    """An artifact written by ``main`` -> an ``ExportedModel`` on
    ``device`` (the CUDA card by default), its draws from ``seed``. The
    program's constants and parameters are moved to the device, device
    arguments in its graph too (``move_to_device_pass``), so an artifact
    traced on the CPU runs on the card, through the kernels."""
    from torch.export.passes import move_to_device_pass

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    _register_ops()
    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    program = move_to_device_pass(program, str(dev))
    return ExportedModel(program.module(), json.loads(extra[META]), dev, seed)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ddsp_svc_tpu_torch.cli.export",
        description="Export a checkpoint's inference forward with torch.export.")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--graph", default=None,
                   help="write the exported graph's text here (JAX: --mlir)")
    p.add_argument("-kstep", "--k_step", type=int, default=None,
                   help="the diffusion cascades' shallow depth (default: the "
                        "model's, none for DiffusionNew / DiffusionFast)")
    p.add_argument("--device", default=None,
                   help="device to trace on (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Export; returns the artifact's metadata with the export's wall
    seconds and size."""
    from ..models.registry import load_model

    cmd = parse_args(argv)
    t0 = time.perf_counter()
    model, args = load_model(cmd.model_path, device=cmd.device)
    frames = int(cmd.seconds * args.data.sampling_rate) // args.data.block_size
    device = next(model.parameters()).device
    program, meta = export_model(model.eval(), args, frames, cmd.k_step, device)
    torch.export.save(program, cmd.output, extra_files={META: json.dumps(meta)})
    size = os.path.getsize(cmd.output)
    print(f"Exported {args.model.type} ({frames} frames) -> {cmd.output} "
          f"({size / 1e6:.2f} MB)")
    if cmd.graph:
        with open(cmd.graph, "w") as f:
            f.write(str(program.graph))
        print(f"graph -> {cmd.graph}")
    return dict(meta, seconds=time.perf_counter() - t0, bytes=size)


if __name__ == "__main__":
    main()
