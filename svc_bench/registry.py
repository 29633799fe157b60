"""Finding a cell's parts by name. ``BENCHMARK.json`` at the checkout's root
names the cells; each part is a file of its own:

- a configuration: the file its entry names (``configs/<config>.json``);
- a traffic mix: ``traffic/<mix>.json``, parameters only, which names the
  kind of its requests (``"source"``) and the system that serves them
  (``"system"``);
- a source of requests: ``sources/<source>.py``, a function
  ``make(mix, seed, sample_rate) -> list[generator.Request]``;
- a system under test: ``systems/<system>.py``, a function
  ``build(cfg, mix, seed, device)`` whose object the harness drives (see
  ``harness.run_cell``);
- a per-layer metric: the reader ``metrics/<metric>.py``, a function
  ``read(run) -> float | None``;
- a cell's correctness limits: ``limits/<cell>.json``.

A later cell, mix, source, system or metric is a new file and a new entry;
no file here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, here: Path = HERE) -> dict:
    """Everything one run of the cell needs, resolved from files."""
    w = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], w["config"], "config")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m, name) and m["moves"] in e2e_names]
    the_mix = mix(w["traffic"], here)
    return {"name": name, "chips": w["chips"],
            "config": json.loads((here.parent / conf["file"]).read_text()),
            "mix": the_mix, "source": source(the_mix["source"], here),
            "system": system(the_mix["system"], here),
            "end_to_end": e2e, "per_layer": layer,
            "readers": {m["name"]: reader(m["name"], here) for m in layer},
            "limits": json.loads((here / "limits" / f"{name}.json").read_text())}


def mix(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def _names(folder: Path, suffix: str) -> list[str]:
    return sorted(p.name[:-len(suffix)] for p in folder.glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def mixes(here: Path = HERE) -> list[str]:
    return _names(here / "traffic", ".json")


def metrics(here: Path = HERE) -> list[str]:
    return _names(here / "metrics", ".py")


def systems(here: Path = HERE) -> list[str]:
    return _names(here / "systems", ".py")


def _module(kind: str, name: str, here: Path):
    """``<kind>/<name>.py`` loaded by path (a name may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"svc_bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name, here).read


def system(name: str, here: Path = HERE):
    """The module ``systems/<name>.py``."""
    return _module("systems", name, here)


def source(name: str, here: Path = HERE):
    """The ``make`` function of ``sources/<name>.py``."""
    return _module("sources", name, here).make
