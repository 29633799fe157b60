"""Compare copies of the port's kernels on one card, in turns.

Each argument names a directory that holds a copy of the package
(``<dir>/ddsp_svc_tpu_torch``: the repository root, the parent commit
unpacked with ``git archive``, or a variant of ``csrc/``). Every copy
builds its own kernel library under ``<dir>/build/kernels`` and runs in its
own process, in the order a, b, ..., b, a, so that drift on the card shows
as a difference between a copy's two runs. Every copy is timed by this
copy's ``tools/timing.py``, at the 10 s request's shapes, each time with
its error against the plain version:

- K2's five stages and K3's layer by CUDA events over back-to-back calls
  (weights packed once, TF32 off for the plain versions); the first run of
  each copy also prints the device time of each of the 18 conv launches
  of the C = 128 and C = 16 stages (torch.profiler), in launch order;
- K1 (the whole ``combtooth()`` call, at T = 862 and at a ten-minute
  T = 51,680) and K4 by replaying calls captured in one CUDA graph, with
  torch.profiler's device time of the kernel, the device operations of one
  call and, for K1, the host wall of one call up to ``synchronize()``;
- K2's bf16 class (B4) per stage at C = 128 ... 16 and the four stages'
  sum, by CUDA events, with its ``bf16_agreement`` against the plain
  version (a copy whose ``cuda_resblock`` has ``FUSED_PLAN`` also times
  one chain per launch at C <= 64, where it runs the whole stage); and
  K3's bf16 class (B3) at B 1 x T 862 and B 48 x T 172, with its
  ``bf16_layer_agreement``, by CUDA events over back-to-back calls and by
  CUDA graph replay (device time: at 10 s the host's work per call is the
  longer); and B5 (B3 on bf16 x and out) at the same shapes, cond f32
  and bf16, with the share of its elements that differ from the plain
  version and each of its launches' device time (torch.profiler);
- K4's bf16-amplitude mode beside K4, the same way.

Every output also gets a digest (SHA-1 of its bytes; the inputs are drawn
from one seed in one order), so that two copies, or a copy's two runs,
can be compared bit for bit. A copy that predates a class skips it.

    python3 -m ddsp_svc_tpu_torch.tools.kernel_ab <dir_a> <dir_b> [...]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r'''
import hashlib, importlib.util, json, math, sys
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("ab_timing", sys.argv[2])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
sys.path.insert(0, sys.argv[1])
import ddsp_svc_tpu_torch
if not ddsp_svc_tpu_torch.__file__.startswith(sys.argv[1]):
    sys.exit(f"imported {ddsp_svc_tpu_torch.__file__}, not the copy in {sys.argv[1]}")
from ddsp_svc_tpu_torch.ops import kernels
from ddsp_svc_tpu_torch.ops.cuda_conformer import conformer_layer, conformer_layer_plain
from ddsp_svc_tpu_torch.ops import cuda_resblock
from ddsp_svc_tpu_torch.ops.cuda_resblock import resblock_group, resblock_group_plain
from ddsp_svc_tpu_torch.ops.cuda_oscillator import harmonic_bank, harmonic_bank_plain
from ddsp_svc_tpu_torch.ops.cuda_source import combtooth, combtooth_plain
from ddsp_svc_tpu_torch.ops.interp import remove_above_fmax
from ddsp_svc_tpu_torch.ops.source import cumsum_phase_source

# a copy from before K2 took packed weights gets the nested list
pack = getattr(cuda_resblock, "PackedResblocks", lambda w: w)

if not torch.cuda.is_available():
    sys.exit("needs a CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.library()
per_launch = len(sys.argv) > 3
if per_launch:  # ptxas's registers and spills of each kernel, once per copy
    entry = None
    for line in kernels.build().log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            print(f"PTXAS {entry[-100:]}: {line.split(':', 1)[-1].strip()}")
ms = timing.cuda_ms


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def digest(*tensors):
    """SHA-1 of the outputs' bytes: copies compared bit for bit."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().flatten().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


gen = torch.Generator().manual_seed(1)
ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
out = {}
for c, per_frame in ((256, 8), (128, 64), (64, 128), (32, 256), (16, 512)):
    x = torch.randn((1, 862 * per_frame, c), generator=gen).cuda()
    w = [[tuple(((torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(c * k)).cuda()
                for shape in ((c, c, k), (c,))) for _ in range(6)] for k in ks]
    packed = pack(w)
    got = resblock_group(x, packed, ks, ds)
    err = rel(got, resblock_group_plain(x, w, ks, ds))
    out[f"K2 C={c}"] = dict(ms=ms(lambda: resblock_group(x, packed, ks, ds), 20), err=err,
                            digest=digest(got))
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
got = conformer_layer(x, cond, step, w)
err = rel(got, conformer_layer_plain(x, cond, step, w))
out["K3"] = dict(ms=ms(lambda: conformer_layer(x, cond, step, w), 200), err=err,
                 digest=digest(got))

from ddsp_svc_tpu_torch.ops import cuda_conformer
if hasattr(cuda_conformer, "conformer_layer_bf16"):
    for b, tt in ((1, 862), (48, 172)):
        xb, cb = (torch.randn((b, tt, n), generator=gen).cuda() for n in (c, hc))
        sb = torch.randn((b, c), generator=gen).cuda()
        packed = cuda_conformer.bf16_gemm_weights(w)
        got = cuda_conformer.conformer_layer_bf16(xb, cb, sb, w, packed)
        agree = cuda_conformer.bf16_layer_agreement(
            got, cuda_conformer.conformer_layer_bf16_plain(xb, cb, sb, w), xb)
        if not agree["ok"]:
            sys.exit(f"B3 B={b} T={tt} disagrees with its plain version: {agree}")
        call = lambda: cuda_conformer.conformer_layer_bf16(xb, cb, sb, w, packed)
        out[f"B3 B={b} T={tt}"] = dict(ms=ms(call, 200 if b == 1 else 50),
                                       graph_ms=timing.graph_ms(call, 50 if b == 1 else 10),
                                       err=agree["rel"], digest=digest(got))
if hasattr(cuda_conformer, "conformer_layer_bf16_io"):
    for b, tt, c16 in ((1, 862, False), (48, 172, False), (1, 862, True), (48, 172, True)):
        xb = torch.randn((b, tt, c), generator=gen).cuda().to(torch.bfloat16)
        cb = torch.randn((b, tt, hc), generator=gen).cuda()
        if c16:
            cb = cb.to(torch.bfloat16)
        sb = torch.randn((b, c), generator=gen).cuda()
        packed = cuda_conformer.bf16_gemm_weights(w)
        got = cuda_conformer.conformer_layer_bf16_io(xb, cb, sb, w, packed)
        agree = cuda_conformer.bf16_io_agreement(
            got, cuda_conformer.conformer_layer_bf16_io_plain(xb, cb, sb, w), xb)
        if not agree["ok"]:
            sys.exit(f"B5 B={b} T={tt} disagrees with its plain version: {agree}")
        call = lambda: cuda_conformer.conformer_layer_bf16_io(xb, cb, sb, w, packed)
        out[f"B5 B={b} T={tt}" + (" cond bf16" if c16 else "")] = dict(
            ms=ms(call, 200 if b == 1 else 50),
            graph_ms=timing.graph_ms(call, 50 if b == 1 else 10),
            split=timing.launch_split(call, "conformer"),
            err=agree["differ"], digest=digest(got))
if hasattr(cuda_resblock, "resblock_group_bf16"):
    plans = getattr(cuda_resblock, "FUSED_PLAN", None)
    others = {128: (), 64: ("chain",), 32: ("chain",), 16: ("chain",)}
    for c2, per_frame in ((128, 64), (64, 128), (32, 256), (16, 512)):
        x2 = torch.randn((1, 862 * per_frame, c2), generator=gen).cuda().to(torch.bfloat16)
        w2 = [[tuple(((torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(c2 * k)).cuda()
                     for shape in ((c2, c2, k), (c2,))) for _ in range(6)] for k in ks]
        packed = cuda_resblock.PackedResblocks(w2)
        want = cuda_resblock.resblock_group_bf16_plain(x2, w2, ks, ds)
        default = plans[c2] if plans else None
        variants = [default] + ([(mode, 128 if c2 == 128 else default[1])
                                 for mode in others[c2]] if plans else [])
        for plan in variants:
            if plans:
                plans[c2] = plan
            try:
                call = lambda: cuda_resblock.resblock_group_bf16(x2, packed, ks, ds)
                agree = cuda_resblock.bf16_agreement(call(), want)
                if not agree["ok"]:
                    sys.exit(f"B4 C={c2} {plan} disagrees with its plain version: {agree}")
                name = f"B4 C={c2}" + ("" if plan == default else f" {plan[0]} {plan[1]}")
                out[name] = dict(ms=ms(call, 20), err=agree["max_abs_err"],
                                 digest=digest(call()))
            finally:
                if plans:
                    plans[c2] = default


def f0_contour(t):
    """chip_smoke.py's: 220 Hz, 5.5 Hz vibrato, an unvoiced tenth."""
    time_s = np.arange(t) * 512 / 44100
    f0 = 220.0 * 2.0 ** (0.5 / 12.0 * np.sin(2 * np.pi * 5.5 * time_s))
    f0[int(0.45 * t):int(0.55 * t)] = 0.0
    return torch.from_numpy(f0.astype(np.float32)[None, :, None]).cuda()

for t in (862, 51680):
    f0 = f0_contour(t)
    got, phase = combtooth(f0, 44100, 512)
    want, want_phase = combtooth_plain(f0, 44100, 512)
    err = max(float((got - want).abs().max()), float((phase - want_phase).abs().max()))
    call = lambda: combtooth(f0, 44100, 512)
    kern, ops, _ = timing.profiled_call(call, "combtooth_kernel")
    out[f"K1 T={t}"] = dict(ms=timing.graph_ms(call, 200 if t < 1000 else 20),
                            err=err, kernel_ms=kern, ops=ops,
                            wall_ms=timing.wall_ms(call), digest=digest(got, phase))
f0 = f0_contour(862)
x = cumsum_phase_source(torch.repeat_interleave(f0, 512, dim=1), 44100, 512).contiguous()
amps = remove_above_fmax(torch.exp(0.5 * torch.randn((1, 862, 128), generator=gen)).cuda()
                         / 128.0, f0, 22050.0).contiguous()
for name, a in (("K4", amps), ("K4 bf16", amps.to(torch.bfloat16))):
    got = harmonic_bank(x, a, 512)
    err = float((got - harmonic_bank_plain(x, a, 512)).abs().max())
    call = lambda: harmonic_bank(x, a, 512)
    kern, ops, _ = timing.profiled_call(call, "harmonic_bank")
    out[name] = dict(ms=timing.graph_ms(call), err=err, kernel_ms=kern, ops=ops,
                     digest=digest(got))
print("RESULT " + json.dumps(out))
'''


def _describe(name: str, res: dict) -> str:
    text = f"{name} {res['ms']:.5f} ms (err {res['err']:.1e}"
    if "graph_ms" in res:
        text += f"; device {res['graph_ms']:.5f} ms by CUDA graph replay"
    if "kernel_ms" in res:
        text += f"; kernel {res['kernel_ms']:.5f} ms by the profiler, {res['ops']:g} device ops"
    if "wall_ms" in res:
        text += f", host wall {res['wall_ms']:.4f} ms"
    if "split" in res:
        text += "; launches " + ", ".join(f"{k} {v:.5f} ms" for k, v in res["split"])
    if "digest" in res:
        text += f"; sha1 {res['digest']}"
    return text + ")"


def main(argv: list[str]) -> None:
    if not argv:
        sys.exit(__doc__)
    timing = os.path.join(os.path.dirname(os.path.abspath(__file__)), "timing.py")
    runs = {d: [] for d in argv}
    failed = False
    for d in argv + argv[::-1]:
        path = os.path.abspath(d)
        args = [sys.executable, "-c", CHILD, path, timing] + (
            ["launches"] if not runs[d] else [])
        r = subprocess.run(args, capture_output=True, text=True, timeout=900)
        lines = r.stdout.splitlines()
        for line in lines:
            if line.startswith(("LAUNCHES", "PTXAS")):
                print(d, line, flush=True)
        result = [line[7:] for line in lines if line.startswith("RESULT ")]
        if r.returncode != 0 or not result:
            print(f"{d} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}",
                  flush=True)
            failed = True
            continue
        runs[d].append(json.loads(result[0]))
    for d in argv:
        for i, res in enumerate(runs[d]):
            k2 = [v["ms"] for name, v in res.items() if name.startswith("K2")]
            b4 = [v["ms"] for name, v in res.items()
                  if name.startswith("B4") and name.count(" ") == 1]
            head = f"K2 five stages {sum(k2):.3f} ms; " if k2 else ""
            head += f"B4 four stages {sum(b4):.4f} ms; " if b4 else ""
            print(f"{d} run {i}: {head}" + "; ".join(
                _describe(name, v) for name, v in res.items()), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
