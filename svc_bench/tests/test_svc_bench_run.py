"""A whole run of a cell, at a size the CPU can hold: the harness drives
the port's batched pipeline, the plain reference agrees with what it
served, and ``correct`` comes out false when the timed path is broken
underneath (a sampler that returns its state unchanged, half of each batch
left out with the rest's mean in its place, an answer altered where it is
produced). A run without a card prints no result."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from svc_bench import harness
from svc_bench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99


def run(config="diffusion-fast", seconds=1.5, door=64):
    cell = tiny_cell(config, door)
    return harness.run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("config,door", [("diffusion-fast", 64), ("reflow", 64),
                                         ("diffusion-fast", 2)])
def test_served_rows_agree_with_the_reference(config, door):
    r = run(config, door=door)
    assert r["failed"] == 0 and r["attempted"] >= 3
    assert r["correct"], r["check"]
    assert all(n["value"] < 1e-4 for n in r["check"].values())
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}


def _stale_sampler(monkeypatch):
    from ddsp_svc_tpu_torch.models import diffusion

    monkeypatch.setattr(diffusion, "sample_dpmpp_2m", lambda x, *a, **k: x)


def _half_batch(monkeypatch):
    """Half of each batch's requests (rounded up) left out of the forward,
    each given the mean of the rest's outputs (zeros when none is left)."""
    from ddsp_svc_tpu_torch.infer import batcher

    forward = batcher.BatchedSynth._forward

    def half(self, bucket, sig, units, f0, volume, spk, seeds, tframes):
        out = forward(self, bucket, sig, units, f0, volume, spk, seeds, tframes)
        real = int((seeds != batcher.DUMMY_SEED).sum())
        kept = real // 2
        out[kept:real] = out[:kept].mean(dim=0) if kept else 0.0
        return out

    monkeypatch.setattr(batcher.BatchedSynth, "_forward", half)


def _altered_answer(monkeypatch):
    from ddsp_svc_tpu_torch.infer.batcher import BatchedSynth

    finish = BatchedSynth._finish

    def altered(self, host, batch, trace, ready):
        if ready is not None:
            ready.synchronize()
        finish(self, host * 1.01, batch, trace, None)

    monkeypatch.setattr(BatchedSynth, "_finish", altered)


@pytest.mark.parametrize("fault", [_stale_sampler, _half_batch, _altered_answer],
                         ids=["stale_step", "half_batch", "altered_answer"])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run()
    assert not r["correct"], r["check"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "svc_bench/run.py", "--workload",
                          "dfast.serve.r60", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "CUDA card" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
