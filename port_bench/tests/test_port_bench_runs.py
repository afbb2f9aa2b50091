"""
The harness on the CPU at 32px: the traffic repeats per seed, the plain
references follow the port, the counts of operations match the hand
counts, the import check compares whole names, a run without a card fails
and prints nothing, and a run whose timed path is broken underneath comes
out not correct. Run with `python -m pytest port_bench/tests -q`.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from port_bench.harness import device as dev
from port_bench.harness import manifest, traffic, weights
from port_bench.reference import opcount
from port_bench.reference import stylegan2 as reference

dev.program_environment()
torch.set_num_threads(4)
ROOT = manifest.ROOT
SEED = 2**31 + 12345  # past 32 signed bits: a run's seed may be that large
CONFIG = json.loads((manifest.BENCH_DIR / "configs" / "stylegan2-f-1024.json").read_text())


def small(name: str, **traffic_keys) -> manifest.Cell:
    cell = manifest.load_cell(name)
    cell.config.update(resolution=32)
    cell.traffic.update(traffic_keys)
    return cell


def run(cell: manifest.Cell, seconds: float = 1.5, seed: int = SEED) -> dict:
    from port_bench.run import run_cell

    return run_cell(cell, seed, seconds, False, "cpu", process_start=time.perf_counter())


def test_traffic_repeats_and_every_seed_gets_the_same_work():
    """The mix's structure comes from its shape_seed; the run's seed only
    draws the values."""
    a = traffic.switching_indices(5000, 2, 30, 19, 2400)
    block = sum(traffic.run_lengths(30, 2400, 19))
    edges = np.concatenate([[0], np.flatnonzero(np.diff(a[:block]) != 0) + 1, [block]])
    assert np.diff(edges).tolist() == traffic.run_lengths(30, 2400, 19)
    assert np.array_equal(a[:5000 - block], a[block:5000])
    assert abs(np.mean(traffic.run_lengths(30, 2400, 19)) - 30) < 5
    assert np.array_equal(traffic.z_rows(7, 512, SEED), traffic.z_rows(7, 512, SEED))
    assert not np.array_equal(traffic.z_rows(7, 512, SEED), traffic.z_rows(7, 512, SEED + 1))
    sends, rows = traffic.open_loop_schedule(10.0, 30.0, 1, 8, 23)
    again, rows_again = traffic.open_loop_schedule(10.0, 30.0, 1, 8, 23)
    assert np.array_equal(sends, again) and np.array_equal(rows, rows_again)
    assert len(sends) == 300 and sends[0] == 0.0 and sends[-1] < 30.0
    assert rows.min() == 1 and rows.max() == 8


def test_weights_repeat_per_seed():
    a = weights.generator_params(dict(CONFIG, resolution=32), SEED, "cpu")
    b = weights.generator_params(dict(CONFIG, resolution=32), SEED, "cpu")
    c = weights.generator_params(dict(CONFIG, resolution=32), SEED, "cpu", stream=1)
    assert torch.equal(a["synthesis"]["32x32"]["Conv1"]["weight"], b["synthesis"]["32x32"]["Conv1"]["weight"])
    assert not torch.equal(a["synthesis"]["32x32"]["Conv1"]["weight"], c["synthesis"]["32x32"]["Conv1"]["weight"])


def test_operation_counts_match_the_hand_counts():
    assert round(opcount.synthesis_conv_macs(CONFIG) / 1e9, 1) == 238.3
    assert round(opcount.synthesis_conv_macs(dict(CONFIG, resolution=256)) / 1e9, 1) == 122.4
    assert CONFIG["conv_gmac_per_frame"] == 238.3


def test_reference_follows_the_port_at_32px():
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    from port_bench.harness.program import generator_config

    config = dict(CONFIG, resolution=32)
    params = weights.generator_params(config, SEED, "cpu")
    net = SynthesisNetwork(params=params, config=generator_config(config),
                           truncation_psi=1.2, compute_dtype=torch.float32, device="cpu")
    z = traffic.z_rows(8, 512, SEED)
    got = net.images_from_vectors(z)
    want = reference.frames_from_z(params, torch.from_numpy(z), config).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    # and a different network does not pass
    other = weights.generator_params(config, SEED, "cpu", stream=1)
    wrong = reference.frames_from_z(other, torch.from_numpy(z), config).numpy()
    assert (np.abs(got.astype(int) - wrong.astype(int)) > 0).mean() > 0.5


def test_banned_modules_compare_whole_top_level_names():
    assert dev.banned_modules(["gance_tpu_torch", "gance_tpu_torch.ops", "jaxtyping"]) == []
    assert dev.banned_modules(["gance_tpu.ops.pallas", "numpy"]) == ["gance_tpu"]
    assert dev.banned_modules(["jax._src", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax_module():
    """Import what every kind and reader of a run imports, in a fresh
    process, and look at sys.modules."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        from port_bench.harness import device, manifest
        device.program_environment()
        import port_bench.run
        from port_bench import control
        for kind in ("render", "serve"):
            manifest.kind_module(kind)
        m = manifest.load_manifest()
        for metric in m["per_layer"]:
            manifest.layer_metric_reader(metric["name"])
        import gance_tpu_torch.synthesis.runtime, gance_tpu_torch.serving.daemon
        print(device.banned_modules())
    """ % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "f1024-render",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()
    # a checkout of the benchmark alone, without the program
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "f1024-render",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", ["f1024-render", "f256-render"])
def test_render_run_on_the_cpu_is_correct(cell):
    line = run(small(cell, max_frames_per_s=200))
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_per_s"]["value"] > 0 and line["attempted"] > 0


def test_render_with_an_altered_frame_is_not_correct(monkeypatch):
    """A frame altered where it is produced: the uint8 epilogue adds one step
    to every value of the batch's first frame."""
    import gance_tpu_torch.models.stylegan2 as model

    plain = model.images_to_uint8

    def altered(images, *args, **kwargs):
        out = plain(images, *args, **kwargs).clone()
        out[0] = out[0] + 1
        return out

    monkeypatch.setattr(model, "images_to_uint8", altered)
    line = run(small("f1024-render", max_frames_per_s=200))
    assert not line["correct"]


def test_render_with_frames_from_the_wrong_network_is_not_correct(monkeypatch):
    from gance_tpu_torch.synthesis.runtime import MultiNetwork

    plain = MultiNetwork.synthesize_stream

    def swapped(self, frame_data, network_indices=None, *args, **kwargs):
        return plain(self, frame_data, 1 - np.asarray(network_indices), *args, **kwargs)

    monkeypatch.setattr(MultiNetwork, "synthesize_stream", swapped)
    line = run(small("f1024-render", max_frames_per_s=200))
    assert not line["correct"]


def test_serve_run_on_the_cpu_is_correct():
    line = run(small("f1024-serve", rate_per_s=4.0), seconds=3.0)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] == 12
    assert line["metrics"]["request_p95_ms"]["value"] > 0


def test_serve_with_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    """The daemon's process alters the first frame of every batch it
    renders (installed through a sitecustomize on its path)."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        import gance_tpu_torch.models.stylegan2 as model
        plain = model.images_to_uint8
        def altered(images, *args, **kwargs):
            out = plain(images, *args, **kwargs).clone()
            out[0] = 255 - out[0]
            return out
        model.images_to_uint8 = altered
    """))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    line = run(small("f1024-serve", rate_per_s=4.0), seconds=3.0)
    assert not line["correct"]



def test_serve_child_holding_the_jax_package_is_reported(tmp_path, monkeypatch):
    """The daemon's process holds a module named `gance_tpu` (planted
    through a sitecustomize on its path): the run hands the name up, and
    run.py prints no result for it."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['gance_tpu'] = types.ModuleType('gance_tpu')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    line = run(small("f1024-serve", rate_per_s=4.0), seconds=1.0)
    assert line["banned"] == ["gance_tpu"]
    assert "gance_tpu" not in sys.modules


def test_sweep_backlog_reads_a_steady_queue_as_steady_and_a_growing_one_as_growing():
    from port_bench.sweep import backlog

    sends = np.sort(np.random.default_rng(1).uniform(0.0, 40.0, 400))
    growth, ratio = backlog(sends, np.full(len(sends), 0.5), 10.0)
    assert abs(growth) < 0.05 and 0.8 < ratio < 1.25
    # one server taking 1/8 s a request, arrivals at 10 a second: 2 a second pile up
    done, last = np.empty(len(sends)), 0.0
    for i, sent in enumerate(sends):
        last = done[i] = max(sent, last) + 0.125
    growth, ratio = backlog(sends, done - sends, 10.0)
    assert 1.5 < growth < 2.5 and ratio > 1.5
