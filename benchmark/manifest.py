"""Loading the benchmark's data: ``BENCHMARK.json`` at the checkout's root,
and the files it names by name under ``benchmark/``:

- ``configs/<config>.json``: a deployment (the program's parameter
  overrides, the sensor, the capacity, the source);
- ``traffic/<traffic>.json``: a traffic mix, the parameters of the one
  general generator (``drivers.py``);
- ``metrics/<metric>.py``: one metric's reader, ``read(run) -> float | None``;
- ``limits/<workload>.json``: the limits of one cell's correctness check.

A later cell, mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, root: Path, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload_name}.json").read_text())


def metrics_of(manifest: dict, workload_name: str, traced: bool) -> List[dict]:
    """The metrics a run of this cell reports: the end-to-end ones without
    a trace, the per-layer ones with it; a metric with a ``workloads`` list
    only in those cells."""
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in group if workload_name in m.get("workloads", [workload_name])]


def reader(metric_name: str) -> Callable[[object], Optional[float]]:
    """The ``read`` function of ``metrics/<metric_name>.py`` (file names
    keep the metric's dots, so the module is loaded from its path)."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(manifest: dict, workload_name: str, traced: bool, run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} for every metric of the cell whose reader
    found something to read."""
    out = {}
    for m in metrics_of(manifest, workload_name, traced):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
