"""
The benchmark's manifest, `BENCHMARK.json` at the root of the checkout, and
the files it names: a cell (`workloads` entry) names a configuration
(`configs/<name>.json` through its `file`) and a traffic mix
(`traffic/<name>.json`, whose `kind` names the runner `kinds/<kind>.py`);
each per-layer metric has its reader `layer_metrics/<name>.py`. Everything is
found by name, so a later cell, configuration, mix or metric is new files and
new manifest entries only.
"""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One workload of the manifest with everything it names, resolved."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    run_seconds: int


def load_manifest(path: Path = MANIFEST) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def metrics_of_cell(manifest: Dict[str, Any], cell: str) -> Dict[str, List[Dict[str, Any]]]:
    """The cell's end-to-end metrics and its per-layer metrics: an entry with
    `workloads` belongs to the cells it lists; one without it belongs to every
    cell (end to end) or to every cell that reports the metric it moves
    (per layer)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return {"end_to_end": e2e, "per_layer": layer}


def load_cell(name: str, manifest_path: Path = MANIFEST) -> Cell:
    manifest = load_manifest(manifest_path)
    root = Path(manifest_path).resolve().parent
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r} in {manifest_path}; cells: {sorted(workloads)}")
    workload = workloads[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[workload["config"]]["file"]).read_text())
    traffic = traffic_file(workload["traffic"])
    metrics = metrics_of_cell(manifest, name)
    return Cell(name=name, chips=int(workload["chips"]), config=config, traffic=traffic,
                end_to_end=metrics["end_to_end"], per_layer=metrics["per_layer"],
                run_seconds=int(manifest["run_seconds"]))


def traffic_file(name: str) -> Dict[str, Any]:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _module_from(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_module(kind: str) -> ModuleType:
    """`kinds/<kind>.py`: the runner of every mix of that kind."""
    return _module_from(BENCH_DIR / "kinds" / f"{kind}.py", f"port_bench_kind_{kind}")


def layer_metric_reader(name: str) -> ModuleType:
    """`layer_metrics/<name>.py`, whose `read(ctx)` returns the metric or None."""
    return _module_from(BENCH_DIR / "layer_metrics" / f"{name}.py",
                        "port_bench_metric_" + re.sub(r"\W", "_", name))
