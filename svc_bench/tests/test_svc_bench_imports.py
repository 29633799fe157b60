"""Nothing the benchmark runs imports JAX or the JAX package: the harness,
the reference, every system's, source's and metric's modules, loaded in
a fresh process, leave no module whose top-level name is jax, jaxlib,
flax, optax or ddsp_svc_tpu in ``sys.modules``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import svc_bench.harness, svc_bench.control, svc_bench.sweep, svc_bench.trace
from svc_bench import registry
from svc_bench.reference import cascade, encoder, f0, params, request, vocoder
import ddsp_svc_tpu_torch.infer.pipeline, ddsp_svc_tpu_torch.features.hubert
import ddsp_svc_tpu_torch.models.registry, ddsp_svc_tpu_torch.models.vocoder
for name in registry.metrics():
    registry.reader(name)
for name in registry.systems():
    registry.system(name)
bench = registry.benchmark()
for w in bench["workloads"]:
    registry.cell(bench, w["name"])
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_no_jax_in_the_benchmark():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "svc_bench" in top and "ddsp_svc_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "optax", "ddsp_svc_tpu"}


def test_the_harness_names_the_forbidden_modules():
    from svc_bench import harness

    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "optax", "ddsp_svc_tpu"}
    # compared whole: the port's name begins with the JAX package's
    assert "ddsp_svc_tpu_torch" not in harness.FORBIDDEN
