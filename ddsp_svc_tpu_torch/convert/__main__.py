"""Converter CLI (mirrors ``python -m ddsp_svc_tpu.convert``; needs no JAX):

python -m ddsp_svc_tpu_torch.convert hubert      <ckpt.pt> <encoder-name> <out.msgpack>
python -m ddsp_svc_tpu_torch.convert nsf-hifigan <model-file> [out.msgpack]
python -m ddsp_svc_tpu_torch.convert rmvpe       <model.pt> [out.msgpack]
python -m ddsp_svc_tpu_torch.convert crepe       <full.pth> [out.msgpack]
python -m ddsp_svc_tpu_torch.convert fcpe        <fcpe.pt> [out.msgpack]
python -m ddsp_svc_tpu_torch.convert model       <model_XXXX.pt> <config.yaml> <out-dir>
"""
from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    if argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    kind, rest = argv[0], argv[1:]
    optional_out = rest[1] if len(rest) > 1 else None
    if kind == "hubert":
        from .hubert import convert_hubert

        convert_hubert(rest[0], rest[1], rest[2])
    elif kind == "nsf-hifigan":
        from .nsf_hifigan import convert_nsf_hifigan

        convert_nsf_hifigan(rest[0], optional_out)
    elif kind == "rmvpe":
        from .rmvpe import convert_rmvpe

        convert_rmvpe(rest[0], optional_out)
    elif kind == "crepe":
        from .crepe import convert_crepe

        convert_crepe(rest[0], optional_out)
    elif kind == "fcpe":
        from .fcpe import convert_fcpe

        convert_fcpe(rest[0], optional_out)
    elif kind == "model":
        from ..utils.config import load_config
        from .models import convert_reference_model

        args = load_config(rest[1])
        os.makedirs(rest[2], exist_ok=True)
        convert_reference_model(rest[0], args,
                                os.path.join(rest[2], os.path.basename(rest[0])))
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
