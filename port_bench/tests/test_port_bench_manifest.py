"""
The manifest against the benchmark's contract, and every name it holds
resolved to its files: configurations, mixes, kinds, per-layer readers,
limits. Run with `python -m pytest port_bench/tests -q`.
"""

import ast
import json
import math

import pytest

from port_bench.harness import manifest

M = manifest.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(M) == TOP_KEYS
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and 1 <= len(M["command"]) <= 32
    for path in M["paths"]:
        assert manifest.NAME_RE.match(path.replace("/", "_")) and len(path) <= 200
        assert (manifest.ROOT / path).is_dir() and not path.startswith("/") and ".." not in path
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells at this length fits its 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def entries():
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
                        ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for entry in M[group]:
            yield group, keys, entry


@pytest.mark.parametrize("group,keys,entry", list(entries()),
                         ids=lambda v: v["name"] if isinstance(v, dict) else None)
def test_entry_keys_names_and_units(group, keys, entry):
    extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
    assert keys <= set(entry) <= keys | extra
    assert manifest.NAME_RE.match(entry["name"])
    if "unit" in entry:
        assert manifest.UNIT_RE.match(entry["unit"])
        assert entry["better"] in ("lower", "higher") and entry["source"] in SOURCES
    for text_key in ("why", "layer", "source"):
        if text_key in entry and group in ("configs", "workloads", "per_layer"):
            text = entry[text_key]
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "workloads":
        assert entry["chips"] in (1, 4)
        assert manifest.NAME_RE.match(entry["config"]) and manifest.NAME_RE.match(entry["traffic"])
    if group == "configs":
        assert len(entry["reduced"]) <= 16


def test_names_unique_and_every_config_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_setup_another_e2e_and_a_layer_metric(cell):
    metrics = manifest.metrics_of_cell(M, cell)
    e2e = {m["name"] for m in metrics["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert metrics["per_layer"]


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_an_e2e_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert metric["moves"] in e2e
    cells = metric.get("workloads") or [w["name"] for w in M["workloads"]]
    for cell in cells:
        reported = {m["name"] for m in manifest.metrics_of_cell(M, cell)["end_to_end"]}
        assert metric["moves"] in reported, (metric["name"], cell)
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_of_one_name_spelled_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cells_found_by_name(cell):
    resolved = manifest.load_cell(cell)
    assert resolved.config["name"] == next(w["config"] for w in M["workloads"] if w["name"] == cell)
    kind = manifest.kind_module(resolved.traffic["kind"])
    assert callable(kind.run)
    for metric in resolved.per_layer:
        assert callable(manifest.layer_metric_reader(metric["name"]).read)
    limits = json.loads((manifest.BENCH_DIR / "limits" / f"{cell}.json").read_text())
    assert limits["limits"] and all(math.isfinite(v) for v in limits["limits"].values())


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_published_widths(config):
    data = json.loads((manifest.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    for key in ("latent_size", "dlatent_size", "mapping_fmaps", "fmap_max"):
        assert data[key] == 512
    assert data["fmap_base"] == 32768 and data["mapping_layers"] == 8
    assert data["resample_kernel"] == [1, 3, 3, 1] and data["mapping_lrmul"] == 0.01
    assert "assumed" in data and "precision" in data
    assert config["reduced"] == []


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    from port_bench.harness.device import BANNED_MODULES

    for path in manifest.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in BANNED_MODULES, (path, name)
