"""The benchmark's files, found by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration, traffic mix and metrics.  Under ``chipbench/``:

* ``configs/<config>.json``: the model's published sizes, its family and
  the engine it is served with (the file ``BENCHMARK.json`` names);
* ``traffic/<traffic>.json``: the parameters of one traffic mix;
* ``checks/<cell>.json``: the limits that decide ``correct`` in a cell;
* ``reference/<family>.py`` and ``adapters/<family>.py``: the plain float32
  forward pass of a model family with its weight layout, and the map of
  those weights into the port's parameter tree;
* ``metrics/<metric>/read.py``: one per-layer metric's reader, with the
  kernel-name patterns of every ``*.txt`` file beside it.

A later cell or metric adds files here and entries in ``BENCHMARK.json``;
no file that is here needs an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    check: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files read."""
    bench = load_json(bench_file)
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in {bench_file}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=workload,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        check=load_json(BENCH_DIR / "checks" / f"{workload}.json"),
        chips=int(w["chips"]),
        end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload))


def reference_of(family: str):
    """``reference/<family>.py``: the weight layout and the plain forward
    (a family's name is a Python identifier)."""
    return importlib.import_module(f"chipbench.reference.{family}")


def adapter_of(family: str):
    """``adapters/<family>.py``: the harness's weights in the port's tree."""
    return importlib.import_module(f"chipbench.adapters.{family}")


def metric_reader(name: str):
    """(read function, kernel-name patterns) of the per-layer metric
    ``name``: ``metrics/<name>/read.py`` and the union of the lines of
    every ``*.txt`` file in that directory (blank lines and ``#`` comments
    left out)."""
    d = BENCH_DIR / "metrics" / name
    mod = load_module(d / "read.py", "chipbench_metric_" +
                      name.replace(".", "_").replace("-", "_"))
    patterns = []
    for f in sorted(d.glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#") and line not in patterns:
                patterns.append(line)
    return mod.read, patterns
