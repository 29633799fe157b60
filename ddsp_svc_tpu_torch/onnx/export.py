"""Emit the reference's four ONNX graphs from a checkpoint (mirrors
ddsp_svc_tpu/onnx/export.py).

The export surface of diffusion/onnx_export.py:126-160 and
diffusion/diffusion_onnx.py:474-564: files ``{project}_encoder.onnx`` /
``_denoise.onnx`` / ``_pred.onnx`` / ``_after.onnx`` with the same input
and output names, shapes, dynamic axes and opset 16, so the artifacts drop
into the same external apps (MoeVoiceStudio / MoeSS-style PNDM hosts).

Covers the 'Diffusion' (Unit2Mel) family, the only family the reference
exports to ONNX; the others export through ``cli.export``. The graphs are
traced on the model's device (the CUDA card unless ``device`` says
otherwise); none of them runs a hand-written kernel.
"""
from __future__ import annotations

import os

import torch

from ..models.registry import load_model
from .mirrors import build_graphs

GRAPHS = ("encoder", "denoise", "pred", "after")
OPSET = 16


def graph_specs(args, model, n_frames: int, device) -> dict:
    """{graph: example inputs, input and output names, dynamic axes} at
    ``n_frames`` frames, the example inputs on ``device``."""
    t = n_frames
    u = args.data.encoder_out_channels
    n_spk = max(int(args.model.n_spk or 1), 1)
    mel_bins = model.decoder.out_dims
    hidden = model.unit_embed.out_features
    k_step_max = model.decoder.k_step
    gen = torch.Generator().manual_seed(0)

    def on(x):
        return x.to(device)

    noise = on(torch.randn(1, 1, mel_bins, t, generator=gen))
    time = on(torch.full((1,), k_step_max - 1, dtype=torch.long))
    return {
        "encoder": dict(
            args=tuple(on(x) for x in (
                torch.randn(1, t, u, generator=gen),
                torch.arange(1, t + 1, dtype=torch.long).unsqueeze(0),
                torch.rand(1, t, generator=gen) * 400.0 + 80.0,
                torch.rand(1, t, generator=gen),
                torch.full((t, n_spk), 1.0 / n_spk))),
            input_names=["hubert", "mel2ph", "f0", "volume", "spk_mix"],
            output_names=["mel_pred"],
            dynamic_axes={"hubert": [1], "mel2ph": [1], "f0": [1],
                          "volume": [1], "spk_mix": [0]}),
        "denoise": dict(
            args=(noise, time, on(torch.randn(1, hidden, t, generator=gen))),
            input_names=["noise", "time", "condition"],
            output_names=["noise_pred"],
            dynamic_axes={"noise": [3], "condition": [2]}),
        "pred": dict(
            args=(noise, on(torch.randn(1, 1, mel_bins, t, generator=gen)), time,
                  on(torch.full((1,), max(k_step_max - 1 - 100, 0),
                                dtype=torch.long))),
            input_names=["noise", "noise_pred", "time", "time_prev"],
            output_names=["noise_pred_o"],
            dynamic_axes={"noise": [3], "noise_pred": [3]}),
        "after": dict(
            args=(noise,), input_names=["x"], output_names=["mel_out"],
            dynamic_axes={"x": [3]}),
    }


def export_onnx(model_path: str, project_name: str | None = None,
                out_dir: str | None = None, n_frames: int = 100,
                graphs=GRAPHS, device: str | torch.device | None = None) -> dict:
    """Export a JAX-format checkpoint -> {graph: path}, the paths
    ``{out_dir}/{project_name}_{graph}.onnx``."""
    from .shim import torch_onnx_export

    model, args = load_model(model_path, device)
    if args.model.type != "Diffusion":
        raise ValueError(
            f"ONNX export covers the 'Diffusion' (Unit2Mel) family -- the "
            f"reference's export surface; got model.type={args.model.type!r}. "
            "Use the torch.export exporter (python -m "
            "ddsp_svc_tpu_torch.cli.export) for other families.")
    model.eval()
    modules = build_graphs(model, args.vocoder.type if args.vocoder else None)
    if project_name is None:
        project_name = os.path.splitext(os.path.basename(model_path))[0]
    out_dir = out_dir or os.path.dirname(model_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    device = next(model.parameters()).device
    specs = graph_specs(args, model, n_frames, device)
    paths = {}
    for name in graphs:
        spec = specs[name]
        path = os.path.join(out_dir, f"{project_name}_{name}.onnx")
        with torch.no_grad():
            torch_onnx_export(modules[name], spec["args"], path,
                              input_names=spec["input_names"],
                              output_names=spec["output_names"],
                              dynamic_axes=spec["dynamic_axes"],
                              opset_version=OPSET)
        paths[name] = path
    return paths
