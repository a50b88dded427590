"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics. Each of them lives in files of its own, found by name:

- ``perfbench/configs/<config>.json``: a deployment of the env;
- ``perfbench/workloads/<cell>.json``: a cell (its configuration, driver,
  traffic and the limits of its correctness check);
- ``perfbench/drivers/<driver>.py``: a driver (``run(ctx) -> records``);
- ``perfbench/metrics/<metric>.py``: a metric's reader
  (``read(records) -> float | None``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(MANIFEST)


def workload(name: str) -> Dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def load_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _covers(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    return [m for m in bench["per_layer" if trace else "end_to_end"] if _covers(m, cell)]


def cell_entry(bench: Dict, cell: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell named {cell!r} in {MANIFEST.name}")
