#!/usr/bin/env python3
"""Where a ``cli.batch_infer`` file parts from the same request run by
``SvcPipeline.infer`` alone, on one CUDA card (ROADMAP C(kk)).

python3 scripts/trace_batch_infer.py [--deterministic]   # from the repository root

It builds chip_smoke.py phase 24 (b)'s pair: the synthetic upstream files
at the published widths converted by the port (``chip_smoke.write_upstream``),
the same four wavs (2, 5, 10 and 12 s), pipeline A as ``cli.batch_infer``
loads it (seed 0's sequence, ``-pe rmvpe``) and pipeline B as the phase's
solo one (seed 1234, the same explicit request seeds). Each file runs
through A, then B, without the hook below (A0, B0: the phase as it runs),
then through A, B and again A and B (A2, B2) with it, k_step 100.

Every module call of the port (a global forward hook) leaves a digest of
its outputs' bits, computed on the card: two int64 sums of the bit
patterns, one plain and one weighted by position. Beside them each run
keeps its stages on the host: units, f0 (RMVPE), volume, the DDSP mel
(the NSF-HiFiGAN's mel of the synth's audio), the denoiser's mel and the
vocoder's audio. For the pairs (A0, B0), (A0, A), (A, B), (A, A2), (B,
B2) and (A2, B2) of each file it prints the first module call whose digest differs, each
stage's max |difference| and the audio's SNR; the last line is one JSON
object of the same. Pairs that agree bit for bit print "identical".
TF32 is off, as in chip_smoke.py. ``--deterministic`` runs it all with
``torch.backends.cudnn.deterministic`` set.
"""
from __future__ import annotations

import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGES = ("units", "f0", "volume", "ddsp mel", "mel", "audio")


def _tensors(out):
    import torch

    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def _digest(t):
    """(plain, position-weighted) int64 sums of the bit patterns of t."""
    import torch

    t = t.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    t = t.contiguous().reshape(-1)
    if t.dtype.is_floating_point:
        t = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
    t = t.to(torch.int64)
    w = torch.arange(t.numel(), device=t.device) % 65521 + 1
    return torch.stack([t.sum(), (t * w).sum()])


class Recorder:
    """Module calls in order as (name, digest tensor) while ``on``."""

    def __init__(self):
        self.names: dict[int, str] = {}
        self.calls: list = []
        self.on = False

    def name(self, prefix: str, module) -> None:
        for n, m in module.named_modules():
            self.names.setdefault(id(m), f"{prefix}.{n}" if n else prefix)

    def hook(self, module, args, out):
        if not self.on:
            return
        ts = list(_tensors(out))
        if ts:
            import torch

            self.calls.append((id(module), type(module).__name__,
                               torch.stack([_digest(t) for t in ts]).sum(0)))


def instrument(pipe) -> None:
    """Wrap the pipeline's stage methods on the instance: each run's first
    output of each stage lands in ``pipe._trace_stages`` (a host array)."""
    import torch

    def host(x):
        return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.float32))

    def wrap(obj, attr, key, pick=lambda r: r):
        inner = getattr(obj, attr)

        def run(*a, **k):
            r = inner(*a, **k)
            stages = pipe._trace_stages
            if stages is not None and key not in stages:
                stages[key] = host(pick(r))
            return r

        setattr(obj, attr, run)

    wrap(pipe, "encode_units", "units")
    wrap(pipe, "extract_f0", "f0")
    wrap(pipe, "volume_and_mask", "volume", lambda r: r[0])
    wrap(pipe.vocoder, "extract", "ddsp mel")  # the cascade's mel_extract_fn
    wrap(pipe, "cascade", "mel")
    wrap(pipe, "vocode", "audio")


def run(pipe, rec: Recorder, wave, sr, seed, digests: bool = True):
    """One request -> (module calls, their digests, stages); without
    ``digests`` no hook runs and the calls are empty."""
    import torch

    stages: dict = {}
    pipe._trace_stages = stages
    rec.calls = []
    rec.on = digests
    try:
        out, _ = pipe.infer(wave, sr, k_step=100, seed=seed)
        torch.cuda.synchronize()
    finally:
        rec.on = False
        pipe._trace_stages = None
    dig = (torch.stack([d for _, _, d in rec.calls]).cpu().numpy()
           if rec.calls else np.zeros((0, 2), np.int64))
    calls = [(i, cls) for i, cls, _ in rec.calls]
    stages["output"] = np.asarray(out, np.float32)
    return calls, dig, stages


def compare(rec: Recorder, a, b) -> dict:
    calls_a, dig_a, st_a = a
    calls_b, dig_b, st_b = b
    first = None
    if not calls_a or not calls_b:
        first = "not traced (a run without the hook)"
    elif len(calls_a) != len(calls_b):
        first = f"call counts differ ({len(calls_a)} vs {len(calls_b)})"
    else:
        for k, ((ia, cls), (ib, _)) in enumerate(zip(calls_a, calls_b)):
            if not np.array_equal(dig_a[k], dig_b[k]):
                first = (f"call {k} of {len(calls_a)}: "
                         f"{rec.names.get(ia, cls)} ({cls})")
                break
    diffs = {}
    for s in STAGES + ("output",):
        x, y = st_a.get(s), st_b.get(s)
        if x is None or y is None or x.shape != y.shape:
            diffs[s] = None if x is None or y is None else "shape"
            continue
        diffs[s] = float(np.abs(x.astype(np.float64) - y).max())
    x, y = st_a["output"].astype(np.float64), st_b["output"].astype(np.float64)
    err = np.sum((x - y) ** 2)
    snr = math.inf if err == 0 else 10 * math.log10(np.sum(x ** 2) / err)
    first_stage = next((s for s in STAGES if diffs.get(s)), None)
    return {"first_call": first, "first_stage": first_stage, "max_abs": diffs,
            "snr_db": snr}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    import chip_smoke as cs
    from ddsp_svc_tpu_torch.features.audio import load_wav, save_wav
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # --deterministic: cuDNN restricted to its deterministic algorithms
    torch.backends.cudnn.deterministic = "--deterministic" in sys.argv[1:]
    name, card = cs.phase_device(torch)
    print(f"[kk] torch.backends.cudnn.deterministic = "
          f"{torch.backends.cudnn.deterministic}", flush=True)
    t_start = time.perf_counter()
    rec = Recorder()
    handle = torch.nn.modules.module.register_module_forward_hook(rec.hook)
    results = {}
    with tempfile.TemporaryDirectory(prefix="trace_batch_infer_") as tmp:
        root = Path(tmp)
        models = cs.write_upstream(root)
        import os

        os.environ["DDSP_SVC_TPU_RMVPE_CKPT"] = str(root / "rmvpe.msgpack")
        rng = np.random.default_rng(cs.SEED + 245)  # phase 24 (b)'s wavs
        files = []
        for rel, seconds in cs.BATCH_INFER_SECONDS.items():
            (root / "in" / rel).parent.mkdir(parents=True, exist_ok=True)
            save_wav(str(root / "in" / rel), cs.voice_wave(seconds, rng), cs.SR)
            files.append(rel)
        files.sort()
        model = str(models["diffusion-fast"])
        pipes = {"A": SvcPipeline(model, pitch_extractor="rmvpe"),
                 "B": SvcPipeline(model, seed=cs.SEED, pitch_extractor="rmvpe")}
        for pipe in pipes.values():
            pipe._trace_stages = None
            instrument(pipe)
        seeds = np.random.default_rng(0)  # cli.batch_infer's sequence
        file_seeds = [int(seeds.integers(1 << 62)) for _ in files]
        runs = {}
        # A0 and B0 without the hook: phase 24 (b) as it runs (the first
        # file through each pipeline is that pipeline's first request)
        for label, key in (("A0", "A"), ("B0", "B"), ("A", "A"), ("B", "B"),
                           ("A2", "A"), ("B2", "B")):
            for rel, seed in zip(files, file_seeds):
                wave, sr = load_wav(str(root / "in" / rel))
                runs[label, rel] = run(pipes[key], rec, wave.astype(np.float32),
                                       sr, seed, digests=not label.endswith("0"))
            if label in ("A", "B"):
                pipe = pipes[key]
                rec.name(f"{key}.model", pipe.model)
                rec.name(f"{key}.vocoder", pipe.vocoder)
                rec.name(f"{key}.encoder", pipe.units_encoder.model)
                for fx in pipe._f0_extractors.values():
                    net = getattr(fx.net, "model", fx.net)
                    if isinstance(net, torch.nn.Module):
                        rec.name(f"{key}.rmvpe", net)
        for rel in files:
            results[rel] = {}
            for pa, pb in (("A0", "B0"), ("A0", "A"), ("A", "B"), ("A", "A2"),
                           ("B", "B2"), ("A2", "B2")):
                c = compare(rec, runs[pa, rel], runs[pb, rel])
                results[rel][f"{pa}-{pb}"] = c
                same = (c["first_call"] in (None, "not traced (a run without the hook)")
                        and c["snr_db"] == math.inf
                        and not any(c["max_abs"].values()))
                print(f"[kk] {rel} {pa} vs {pb}: "
                      + ("identical" if same else
                         f"first differing module call {c['first_call']}; "
                         f"first differing stage {c['first_stage']}; max |diff| "
                         + ", ".join(f"{s} {v if isinstance(v, str) or v is None else f'{v:.3e}'}"
                                     for s, v in c["max_abs"].items())
                         + f"; audio SNR {c['snr_db']:.2f} dB")
                      + f" [{card}]", flush=True)
    handle.remove()
    print(f"[kk] traced in {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"card": name, "results": results}, default=str))


if __name__ == "__main__":
    main()
