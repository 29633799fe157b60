"""Run-to-run repeatability of the port's CPU CombSubSuperFast forward.

``chip_smoke.py`` phase 22 holds the card's streamed output against CPU
ranks', and the CPU ranks' against the CPU's whole forward. This probe
asks whether the CPU forward can change from one call or process to the
next, where, and why a change there shows as much as it does:

  1. ``configs/combsub.yaml``'s model (phase 22's random weights and
     inputs) runs three forward calls in each of ``--processes`` fresh
     processes. Each call records the exciter, the control network's
     filters, the square root in its output layer's weight norm (WNLinear)
     and the output. A process whose first call differs from its later
     ones is counted, with the first stage that differs; where ``gcc`` is
     found, the odd square roots are checked against x * rsqrtps(x). With
     ``--busy`` another process keeps every core busy with matmuls
     meanwhile.
  2. The output's sensitivity: one process perturbs the exciter, then the
     filters, by a relative 2**-24 (one f32 rounding) and reports the
     output's change relative to its peak.

Run it on the machine whose CPU is in question, from the repo root:
``python3 scripts/probe_cpu_repeatability.py [--root CHECKOUT]``, where
``--root`` names another checkout of the repo whose port and chip_smoke.py
to run (another commit's, to compare). It needs no card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

STAGES = ("comb", "norm", "src_filter", "noise_filter", "out")  # as they run
SQRT_ODD = 1e-5  # a square root this far off f64's is not f32's rounding

_RSQRTPS_C = r"""
#include <immintrin.h>
#include <stdio.h>
int main(int argc, char **argv) {  /* x (f32 file) -> x * rsqrtps(x) */
  FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
  float x;
  while (fread(&x, 4, 1, in) == 1) {
    __m128 v = _mm_set1_ps(x);
    float y = _mm_cvtss_f32(_mm_mul_ps(v, _mm_rsqrt_ps(v)));
    fwrite(&y, 4, 1, out);
  }
  return 0;
}
"""


def _case(path: str, seconds: float) -> None:
    """Write phase 22's combsub model and its first ``seconds`` of inputs
    to ``path``."""
    import torch

    import chip_smoke as cs

    x, parts = cs._stream_parts(torch)
    model, names, kw = parts["combsub"]
    _, args, kwargs = cs._stream_call(torch, "combsub", model, names, kw, x,
                                      cs.frames_for(seconds), "cpu")
    torch.save((model, args[1:], kwargs), path)  # args[0] is the model


def _recorded(model, args, kwargs) -> dict:
    """One whole forward -> {stage: tensor}, the WNLinear norm's input as
    ``norm2``."""
    import torch

    from ddsp_svc_tpu_torch.models import ddsp

    rec = {}
    comb_fn, controls = ddsp.combtooth, model.controls
    lin = model.unit2ctrl.dense_out

    def comb_rec(*a, **k):
        rec["comb"], phase = comb_fn(*a, **k)
        return rec["comb"], phase

    def controls_rec(*a, **k):
        src, nf, hidden = controls(*a, **k)
        rec["src_filter"], rec["noise_filter"] = src, nf
        return src, nf, hidden

    def weight():  # WNLinear.weight, its norm recorded
        v = lin.weight_v
        rec["norm2"] = torch.sum(v * v, dim=1)
        rec["norm"] = torch.sqrt(rec["norm2"])
        return v * (lin.weight_g / (rec["norm"] + 1e-12))[:, None]

    ddsp.combtooth = comb_rec
    model.controls, lin.weight = controls_rec, weight
    try:
        with torch.no_grad():
            rec["out"] = model(*args, **kwargs)[0]
    finally:
        ddsp.combtooth = comb_fn
        model.__dict__.pop("controls", None)
        lin.__dict__.pop("weight", None)
    return rec


def _child(case: str, out: str) -> None:
    import torch

    model, args, kwargs = torch.load(case, weights_only=False)
    torch.save([_recorded(model, args, kwargs) for _ in range(3)], out)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _sqrt_err(rec) -> float:
    want = rec["norm2"].double().sqrt()
    return float(((rec["norm"].double() - want) / want).abs().max())


def _rsqrtps_matches(norm2, norm, tmp: str) -> str:
    """How many of the odd square roots equal x * rsqrtps(x) bit for bit."""
    gcc = shutil.which("gcc")
    if gcc is None:
        return "gcc not found: not checked against x * rsqrtps(x)"
    src, exe = os.path.join(tmp, "rsqrtps.c"), os.path.join(tmp, "rsqrtps")
    Path(src).write_text(_RSQRTPS_C)
    subprocess.run([gcc, "-O1", "-msse", src, "-o", exe], check=True)
    want = norm2.double().sqrt()
    odd = (norm.double() - want).abs() > SQRT_ODD * want
    x = norm2[odd].numpy().astype(np.float32)
    x.tofile(os.path.join(tmp, "x.f32"))
    subprocess.run([exe, os.path.join(tmp, "x.f32"),
                    os.path.join(tmp, "y.f32")], check=True)
    y = np.fromfile(os.path.join(tmp, "y.f32"), np.float32)
    same = int((y == norm[odd].numpy()).sum())
    return (f"{same} of the first odd process's {len(x)} odd square roots "
            "equal x * rsqrtps(x) bit for bit")


def _sensitivity(case: str) -> None:
    import torch

    from ddsp_svc_tpu_torch.models import ddsp

    model, args, kwargs = torch.load(case, weights_only=False)
    ref = _recorded(model, args, kwargs)["out"]
    gen = torch.Generator().manual_seed(0)

    def nudge(x):
        u = torch.rand(x.shape, generator=gen) * 2 - 1
        return x * (1 + 2.0 ** -24 * u).to(x.dtype)

    comb_fn, controls = ddsp.combtooth, model.controls

    def comb_nudged(*a, **k):
        c, p = comb_fn(*a, **k)
        return nudge(c), p

    def controls_nudged(*a, **k):
        src, nf, hidden = controls(*a, **k)
        return nudge(src), nudge(nf), hidden

    for what in ("exciter", "filters"):
        if what == "exciter":
            ddsp.combtooth = comb_nudged
        else:
            model.controls = controls_nudged
        try:
            with torch.no_grad():
                out = model(*args, **kwargs)[0]
        finally:
            ddsp.combtooth = comb_fn
            model.__dict__.pop("controls", None)
        print(f"sensitivity: the {what} times (1 + 2^-24 u), u in [-1, 1]: "
              f"the output moves {_rel(out, ref):.3e} of its peak", flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                   help="the checkout whose port and chip_smoke.py to run")
    p.add_argument("--processes", type=int, default=30)
    p.add_argument("--seconds", type=float, default=10.0,
                   help="the input's length (phase 22's is 10 s)")
    p.add_argument("--busy", action="store_true",
                   help="run the processes beside one that keeps every core "
                        "busy")
    p.add_argument("--child", nargs=2, metavar=("CASE", "OUT"))
    a = p.parse_args()
    sys.path.insert(0, str(Path(a.root).resolve()))
    if a.child:
        _child(*a.child)
        return
    import torch

    print(f"{a.root}{' (beside a busy process)' if a.busy else ''}: torch "
          f"{torch.__version__}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}, {os.cpu_count()} cores, "
          f"{torch.get_num_threads()} intra-op threads, MKL "
          f"{torch.backends.mkl.is_available()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="probe_cpu_")
    busy = subprocess.Popen([sys.executable, "-c", (
        "import torch\na = torch.randn(2048, 2048)\nwhile True:\n    a @ a\n")]
    ) if a.busy else None
    try:
        case = os.path.join(tmp, "case.pt")
        _case(case, a.seconds)
        odd, first_odd = [], None
        for i in range(a.processes):
            out = os.path.join(tmp, f"run{i}.pt")
            subprocess.run([sys.executable, __file__, "--root", a.root,
                            "--child", case, out], check=True)
            calls = torch.load(out)
            diff = {s: _rel(calls[0][s], calls[-1][s]) for s in STAGES}
            later = _rel(calls[1]["out"], calls[2]["out"])
            if any(diff.values()) or later:
                stage = next((s for s in STAGES if diff[s]), "none")
                odd.append(i)
                first_odd = first_odd or calls[0]
                print(f"process {i}: first call against the third: "
                      + ", ".join(f"{s} {v:.3e}" for s, v in diff.items())
                      + f"; first stage to differ: {stage}; its square roots "
                      f"off f64's by {_sqrt_err(calls[0]):.3e} (the third "
                      f"call's {_sqrt_err(calls[-1]):.3e}); second against "
                      f"third {later:.3e}", flush=True)
        print(f"{len(odd)} of {a.processes} fresh processes gave a first "
              f"forward unlike their later ones: {odd}", flush=True)
        if first_odd is not None:
            print(_rsqrtps_matches(first_odd["norm2"], first_odd["norm"], tmp),
                  flush=True)
        _sensitivity(case)
    finally:
        if busy is not None:
            busy.kill()
            busy.wait()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
