"""Launch the web GUI shell (mirrors ddsp_svc_tpu/cli/gui.py; the
reference's gui.py / gui_diff.py / gui_reflow.py as one family-agnostic
shell: the model family is read from the loaded checkpoint's config, as in
cli/infer.py). The pipeline runs on the CUDA card unless ``--device`` says
otherwise; without a card and without ``--device`` it raises before it
serves.

    python -m ddsp_svc_tpu_torch.cli.gui [--port 7860] [--model ckpt] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m ddsp_svc_tpu_torch.cli.gui",
                                description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--model", default=None, help="checkpoint to preload")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None, ready_cb=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    from ..gui.web import GuiApp, serve

    app = GuiApp(device=device)
    if args.model:
        app.load_model(args.model)
    serve(app, host=args.host, port=args.port, ready_cb=ready_cb)


if __name__ == "__main__":
    main()
