"""Compare copies of the port's K2 and K3 kernels on one card, in turns.

Each argument names a directory that holds a copy of the package
(``<dir>/ddsp_svc_tpu_torch``: the repository root, the parent commit
unpacked with ``git archive``, or a variant of ``csrc/``). Every copy
builds its own kernel library under ``<dir>/build/kernels`` and runs in its
own process, in the
order a, b, ..., b, a, so that drift on the card shows as a difference
between a copy's two runs. Each run times K2's five stages and K3's layer
at the 10 s request's shapes (CUDA events, weights packed once, TF32 off
for the plain versions) and prints each time with its error against the
plain version; the first run of each copy also prints the device time of
each of the 18 conv launches of the C = 128 and C = 16 stages
(torch.profiler), in launch order.

    python3 -m ddsp_svc_tpu_torch.tools.kernel_ab <dir_a> <dir_b> [...]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r'''
import json, math, sys
import torch
sys.path.insert(0, sys.argv[1])
import ddsp_svc_tpu_torch
if not ddsp_svc_tpu_torch.__file__.startswith(sys.argv[1]):
    sys.exit(f"imported {ddsp_svc_tpu_torch.__file__}, not the copy in {sys.argv[1]}")
from ddsp_svc_tpu_torch.ops import kernels
from ddsp_svc_tpu_torch.ops.cuda_conformer import conformer_layer, conformer_layer_plain
from ddsp_svc_tpu_torch.ops import cuda_resblock
from ddsp_svc_tpu_torch.ops.cuda_resblock import resblock_group, resblock_group_plain

# a copy from before K2 took packed weights gets the nested list
pack = getattr(cuda_resblock, "PackedResblocks", lambda w: w)

if not torch.cuda.is_available():
    sys.exit("needs a CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.library()
per_launch = len(sys.argv) > 2


def ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


gen = torch.Generator().manual_seed(1)
ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
out = {}
for c, per_frame in ((256, 8), (128, 64), (64, 128), (32, 256), (16, 512)):
    x = torch.randn((1, 862 * per_frame, c), generator=gen).cuda()
    w = [[tuple(((torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(c * k)).cuda()
                for shape in ((c, c, k), (c,))) for _ in range(6)] for k in ks]
    packed = pack(w)
    err = rel(resblock_group(x, packed, ks, ds), resblock_group_plain(x, w, ks, ds))
    out[f"K2 C={c}"] = (ms(lambda: resblock_group(x, packed, ks, ds), 20), err)
    if per_launch and c in (128, 16):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            resblock_group(x, packed, ks, ds)
            torch.cuda.synchronize()
        print(f"LAUNCHES C={c}: " + json.dumps(
            [round(e.device_time_total / 1e3, 4) for e in prof.events()
             if "resblock" in e.name and e.device_time_total > 0]))
t, c, hc, inner, k = 862, 512, 128, 1024, 31
x, cond = (torch.randn((1, t, n), generator=gen).cuda() for n in (c, hc))
step = torch.randn((1, c), generator=gen).cuda()
w = tuple(((torch.rand(shape, generator=gen) * 2 - 1) * scale).cuda() for shape, scale in (
    ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5), ((2 * inner,), 0.1),
    ((inner, k), k ** -0.5), ((inner,), 0.1), ((c, inner), inner ** -0.5), ((c,), 0.1)))
err = rel(conformer_layer(x, cond, step, w), conformer_layer_plain(x, cond, step, w))
out["K3"] = (ms(lambda: conformer_layer(x, cond, step, w), 200), err)
print("RESULT " + json.dumps(out))
'''


def main(dirs: list[str]) -> None:
    if not dirs:
        sys.exit(__doc__)
    runs = {d: [] for d in dirs}
    failed = False
    for d in dirs + dirs[::-1]:
        path = os.path.abspath(d)
        args = [sys.executable, "-c", CHILD, path] + (["launches"] if not runs[d] else [])
        r = subprocess.run(args, capture_output=True, text=True, timeout=900)
        lines = r.stdout.splitlines()
        for line in lines:
            if line.startswith("LAUNCHES"):
                print(d, line, flush=True)
        result = [line[7:] for line in lines if line.startswith("RESULT ")]
        if r.returncode != 0 or not result:
            print(f"{d} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}",
                  flush=True)
            failed = True
            continue
        runs[d].append(json.loads(result[0]))
    for d in dirs:
        for i, res in enumerate(runs[d]):
            k2 = sum(ms for name, (ms, _) in res.items() if name.startswith("K2"))
            print(f"{d} run {i}: K2 five stages {k2:.3f} ms; " + "; ".join(
                f"{name} {ms:.3f} ms (err {err:.1e})" for name, (ms, err) in res.items()),
                flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
