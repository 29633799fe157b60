"""The traffic generator repeats by seed and gives every seed the same
work; the door keeps the requests in flight at its width; the harness finds
mixes, sources, systems, metrics and cells by name from files, so a new one
is a new file that runs without an edit to the harness."""
import json
import shutil
import threading
import time

import numpy as np
import torch

from svc_bench import generator, harness, registry

MIX = "open.r60"


def _voices(mix, seed):
    return registry.source(mix["source"])(mix, seed, 44100)


def test_same_seed_same_requests():
    mix = dict(registry.mix(MIX), pool=8)
    a, b = _voices(mix, 2 ** 31 + 5), _voices(mix, 2 ** 31 + 5)
    for x, y in zip(a, b):
        assert x.seed == y.seed and x.pitch_hz == y.pitch_hz
        np.testing.assert_array_equal(x.audio, y.audio)
    np.testing.assert_array_equal(generator.gaps(mix, 2 ** 31 + 5),
                                  generator.gaps(mix, 2 ** 31 + 5))


def test_seeds_share_the_work_and_differ_in_order():
    mix = dict(registry.mix(MIX), pool=8)
    a, b = _voices(mix, 1), _voices(mix, 2)
    assert sorted(len(r.audio) for r in a) == sorted(len(r.audio) for r in b)
    assert [len(r.audio) for r in a] != [len(r.audio) for r in b]
    assert {r.seed for r in a} != {r.seed for r in b}
    np.testing.assert_allclose(np.sort(generator.gaps(mix, 1)),
                               np.sort(generator.gaps(mix, 2)))


def test_lengths_fill_every_bucket():
    mix = registry.mix(MIX)
    lengths = generator.quantiles(mix["length_s"], mix["pool"])
    frames = (lengths * 44100).astype(int) // 512 + 1
    buckets = sorted(mix["serve"]["buckets"])
    used = {next(b for b in buckets if f <= b) for f in frames}
    assert used == set(buckets)


class _Slow:
    """A system that answers after a fixed time and counts what is in flight."""

    def __init__(self, seconds):
        self.seconds, self.lock, self.now, self.most = seconds, threading.Lock(), 0, 0

    def serve(self, request, seed):
        with self.lock:
            self.now += 1
            self.most = max(self.most, self.now)
        time.sleep(self.seconds)
        with self.lock:
            self.now -= 1
        return request.audio


def test_the_door_holds_the_requests_in_flight():
    """Far above capacity the door stays full and no more pass it; nothing
    is admitted after the window's seconds, and the window closes when the
    last admitted request is answered."""
    mix = dict(registry.mix(MIX), pool=8, door=3, rate_rps=1000.0)
    requests = _voices(mix, 3)
    system = _Slow(0.05)
    t_open, t_close, done = harness.drive(system, requests, mix, 0.5,
                                          generator.gaps(mix, 3))
    assert system.most == 3
    assert max(d.t0 for d in done) < t_open + 0.5
    assert t_close == max(d.t1 for d in done)
    # three at a time, 0.05 s each: about 30 in 0.5 s, not the 500 offered
    assert 15 <= len(done) <= 33
    assert [d.cycle for d in done[:9]] == [0] * 8 + [1]


SYSTEM = '''
import numpy as np
from svc_bench import check


def build(cfg, mix, seed, device):
    return Echo(mix)


class Echo:
    """Answers each request with its audio times the mix's gain."""
    sample_rate = out_rate = 100

    def __init__(self, mix):
        self.gain, self.counters = mix["gain"], {}

    def warm(self):
        pass

    def serve(self, request, seed):
        return request.audio * self.gain

    def watch(self, requests, n, seed):
        return set(range(min(n, len(requests))))

    def open_window(self, watch_seeds, traced):
        self.counters = {"opened": 1}

    def close_window(self):
        pass

    def release(self):
        pass

    def readings(self, picked):
        return [{"err": check.rel_err(d.output, d.request.audio)} for d in picked]
'''

SOURCE = '''
import numpy as np
from svc_bench.generator import Request


def make(mix, seed, sample_rate):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.standard_normal(mix["samples"]).astype(np.float32),
                    int(rng.integers(1, 1 << 40)), 0.0) for i in range(mix["pool"])]
'''


def test_a_new_cell_runs_from_new_files_alone(tmp_path):
    """A mix, a source of requests, a system, a metric and a cell, each a
    new file and a new entry, run through the harness as it stands."""
    here = tmp_path / "svc_bench"
    for d in ("traffic", "metrics", "configs", "limits", "sources", "systems"):
        shutil.copytree(registry.HERE / d, here / d)
    (here / "systems" / "echo.py").write_text(SYSTEM)
    (here / "sources" / "noise.py").write_text(SOURCE)
    mix = {"source": "noise", "system": "echo", "rate_rps": 200.0, "door": 4,
           "pool": 5, "samples": 50, "gain": 1.0, "warm_s": 0.1, "check": {"requests": 3}}
    (here / "traffic" / "echo.mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "echo.opened.py").write_text(
        "def read(run):\n    return 100.0 * run.counters['opened']\n")
    (here / "limits" / "dfast.echo.json").write_text(
        '{"echo_err_max": {"reading": "err", "limit": 1e-6}}')
    assert "echo.mix" in registry.mixes(here)
    assert "echo.opened" in registry.metrics(here)
    assert "echo" in registry.systems(here)
    bench = registry.benchmark()
    bench["workloads"].append({"name": "dfast.echo", "config": "diffusion-fast",
                               "traffic": "echo.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "echo.opened", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "batcher",
                               "moves": "audio_s_per_s", "workloads": ["dfast.echo"]})
    cell = registry.cell(bench, "dfast.echo", here)
    assert [m["name"] for m in cell["per_layer"]] == ["echo.opened"]
    cpu = torch.device("cpu")
    r = harness.run_cell(cell, 2 ** 31 + 7, 0.3, False, cpu, time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 5
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert r["check"]["echo_err_max"]["value"] == 0.0
    run = harness.Run(cell["config"], cell["mix"], 1.0, [], {"opened": 1})
    assert cell["readers"]["echo.opened"](run) == 100.0
    # the same cell with a wrong answer is not correct
    cell["mix"] = dict(mix, gain=1.01)
    r = harness.run_cell(cell, 2 ** 31 + 7, 0.3, False, cpu, time.perf_counter())
    assert not r["correct"]


def test_every_cell_resolves():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        assert cell["per_layer"] and cell["end_to_end"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "audio_s_per_s"}
        for m in cell["per_layer"]:
            assert m["name"] in registry.metrics()
        assert cell["mix"]["system"] in registry.systems()
