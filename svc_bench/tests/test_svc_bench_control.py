"""The control fails the limits: the plain reference in TF32 (the nearest
precision below the configuration's float32), in the program's place, reads
above one of the cell's limits or more on every seed, where the program reads
within each of them. Needs
the card (TF32 exists only there); runs at a small size:

    python3 -m pytest svc_bench/tests/test_svc_bench_control.py -m cuda \\
        --noconftest -o addopts=""
"""
import pytest
import torch

from svc_bench import control, registry

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dfast.serve.r60", "reflow.serve.r60"])
def test_control_fails_the_limit(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = registry.cell(registry.benchmark(), workload)
    cell["mix"] = dict(cell["mix"], pool=16, check={"requests": 4})
    rows = control.readings(cell, list(SEEDS), len(SEEDS), 3.0, torch.device("cuda", 0))
    for row in rows:
        assert row["failed"] == 0
        prog = {name: max(e[n["reading"]] for e in row["program"])
                for name, n in cell["limits"].items()}
        ctrl = {name: max(e[n["reading"]] for e in row["control"])
                for name, n in cell["limits"].items()}
        assert all(prog[k] <= n["limit"] for k, n in cell["limits"].items()), prog
        assert any(ctrl[k] > n["limit"] for k, n in cell["limits"].items()), ctrl
