"""Finds the benchmark's parts by name.

- `BENCHMARK.json` at the checkout's root: the cells and the metrics.
- `configs/<config>.json`: a configuration; its `generator` key names
  `gen/<generator>.py`, and its `layout` block (`chips`, `data_nodes`,
  `mesh`; `harness.Layout`) the cards, the data nodes and each node's
  mesh that the harness builds and measures. A cell's `chips` in
  `BENCHMARK.json` is its configuration's `layout.chips`.
- `mixes/<traffic>.json`: a traffic mix.
- `metrics/<metric>.py`: a metric's reader, a module with
  `read(run) -> float | None`. A name with dots that has no file of its
  own (`query_p90_ms.tpch-sf50.timeseries`) is read by the file of its
  first part (`query_p90_ms.py`).

Adding a configuration, a mix or a metric adds files; none is edited,
a configuration over several cards and meshes included.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def mixes() -> List[str]:
    return sorted(p.stem for p in (HERE / "mixes").glob("*.json"))


def configs() -> List[str]:
    return sorted(p.stem for p in (HERE / "configs").glob("*.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def metric_path(name: str) -> Path:
    own = HERE / "metrics" / f"{name}.py"
    if own.exists():
        return own
    return HERE / "metrics" / f"{name.split('.')[0]}.py"


_READERS: Dict[Path, object] = {}


def reader(name: str):
    path = metric_path(name)
    if path not in _READERS:
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{path.stem.replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[path] = mod
    return _READERS[path]
