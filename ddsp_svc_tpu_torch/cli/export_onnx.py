"""ONNX export CLI (mirrors ddsp_svc_tpu/cli/export_onnx.py; the reference's
diffusion/onnx_export.py:215-226).

Exports a 'Diffusion' (Unit2Mel) checkpoint as the four ONNX graphs the
external apps (MoeVoiceStudio / MoeSS-style PNDM hosts) consume, traced on
the CUDA card unless ``--device`` says otherwise, then with ``--check``
proves the artifacts against the checkpoint with the in-repo numpy ONNX
runtime (no onnx / onnxruntime wheels needed).

python -m ddsp_svc_tpu_torch.cli.export_onnx -m exp/diff/model_100000.ckpt \\
    [-o outdir] [--project myvoice] [--graphs encoder,denoise,pred,after] \\
    [--check] [--n_frames 100] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..onnx.export import GRAPHS, export_onnx

CHECK_SNR_DB = 60.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m ddsp_svc_tpu_torch.cli.export_onnx")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-o", "--out_dir", default=None,
                   help="output directory (default: checkpoint directory)")
    p.add_argument("--project", default=None,
                   help="artifact prefix (default: checkpoint basename)")
    p.add_argument("--graphs", default=",".join(GRAPHS),
                   help="comma-separated subset of encoder,denoise,pred,after")
    p.add_argument("--n_frames", type=int, default=100,
                   help="trace length (dynamic axes make this cosmetic)")
    p.add_argument("--check", action="store_true",
                   help="validate the artifacts vs the checkpoint (PNDM chain "
                        "through the numpy ONNX runtime) and print the SNR")
    p.add_argument("--device", default=None,
                   help="torch device to trace on (default: the CUDA card)")
    return p


def main(argv=None) -> dict:
    """Export (and with --check validate); returns {graph: path}."""
    p = build_parser()
    cmd = p.parse_args(argv)
    graphs = tuple(g.strip() for g in cmd.graphs.split(",") if g.strip())
    unknown = set(graphs) - set(GRAPHS)
    if unknown:
        p.error(f"unknown graphs: {sorted(unknown)} (choose from {GRAPHS})")
    if cmd.check and set(graphs) != set(GRAPHS):
        p.error("--check needs all four graphs")

    paths = export_onnx(cmd.model_path, project_name=cmd.project,
                        out_dir=cmd.out_dir, n_frames=cmd.n_frames,
                        graphs=graphs, device=cmd.device)
    for name, path in paths.items():
        print(f" [onnx] {name}: {path}")
    if cmd.check:
        from ..onnx.validate import validate_export

        stats = validate_export(cmd.model_path, paths, device=cmd.device)
        print(f" [onnx] check: {stats['snr_db']:.1f} dB SNR vs checkpoint "
              f"({stats['steps']}-step PNDM, max abs err {stats['max_abs']:.2e})")
        if stats["snr_db"] < CHECK_SNR_DB:
            raise SystemExit(" [onnx] FAIL: exported chain diverges from the "
                             "checkpoint")
    return paths


if __name__ == "__main__":
    main()
