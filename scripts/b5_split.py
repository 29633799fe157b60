"""B5's device time and its three launches, for copies of the package.

Each argument names a directory holding a copy of ``ddsp_svc_tpu_torch``
(the repository root, the parent commit unpacked with ``git archive``, or a
copy with an edited ``csrc/`` for an ablation). Each copy builds its own
kernel library and runs in its own process, in the order a, b, ..., b, a,
and is timed by this checkout's ``tools/timing.py``: B5 at B 48 x T 172
and B 24 x T 344 (C 512, Hc 128, I 1024, k 31), the layer by CUDA graph
replay and each launch by torch.profiler, with its ``bf16_io_agreement``
against the plain version and, for a copy that has it, the count of floats
at which B3's and B5's branch-free reciprocal differs from the division.
The first run of each copy also prints ptxas's registers and spills of the
persistent GLU + depthwise launch.

    python3 scripts/b5_split.py ab/parent . [ab/variant ...]
"""
from __future__ import annotations

import os
import subprocess
import sys

CHILD = r'''
import ctypes, importlib.util, json, sys
spec = importlib.util.spec_from_file_location("ab_timing", sys.argv[2])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
sys.path.insert(0, sys.argv[1])
import torch
import ddsp_svc_tpu_torch
if not ddsp_svc_tpu_torch.__file__.startswith(sys.argv[1]):
    sys.exit(f"imported {ddsp_svc_tpu_torch.__file__}, not the copy in {sys.argv[1]}")
from ddsp_svc_tpu_torch.ops import kernels, cuda_conformer as cc

if not torch.cuda.is_available():
    sys.exit("needs a CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
lib = kernels.library()
if len(sys.argv) > 3:
    entry = None
    for line in kernels.build().log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "glu_dw" in entry and ("registers" in line or "spill" in line):
            print("PTXAS", line.split(":", 1)[-1].strip())
if hasattr(lib, "ddsp_rcp_fast_mismatches"):
    fn = lib.ddsp_rcp_fast_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert fn(count.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    print("RCP mismatches", int(count.item()))
gen = torch.Generator().manual_seed(1)
c, hc, inner, k = 512, 128, 1024, 31
w = tuple(((torch.rand(shape, generator=gen) * 2 - 1) * scale).cuda() for shape, scale in (
    ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5), ((2 * inner,), 0.1),
    ((inner, k), k ** -0.5), ((inner,), 0.1), ((c, inner), inner ** -0.5), ((c,), 0.1)))
packed = cc.bf16_gemm_weights(w)
out = {}
for b, t in ((48, 172), (24, 344)):
    x = torch.randn((b, t, c), generator=gen).cuda().to(torch.bfloat16)
    cond = torch.randn((b, t, hc), generator=gen).cuda()
    step = torch.randn((b, c), generator=gen).cuda()
    call = lambda: cc.conformer_layer_bf16_io(x, cond, step, w, packed)
    got = call()
    agree = cc.bf16_io_agreement(got, cc.conformer_layer_bf16_io_plain(x, cond, step, w), x)
    out[f"B{b}xT{t}"] = dict(graph_ms=timing.graph_ms(call, 10),
                             split=timing.launch_split(call, "conformer", 10),
                             ok=agree["ok"], differ=agree["differ"])
print("RESULT " + json.dumps(out))
'''


def main(argv: list[str]) -> None:
    if not argv:
        sys.exit(__doc__)
    timing = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "ddsp_svc_tpu_torch", "tools", "timing.py")
    seen = set()
    for d in argv + argv[::-1]:
        args = [sys.executable, "-c", CHILD, os.path.abspath(d),
                os.path.abspath(timing)] + ([] if d in seen else ["first"])
        seen.add(d)
        r = subprocess.run(args, capture_output=True, text=True, timeout=900)
        for line in r.stdout.splitlines():
            print(d, line, flush=True)
        if r.returncode:
            print(d, "failed:", r.stderr[-2000:], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
