"""
The reader of `demod_folded_share.render` (layer_metrics/): on counters
planted under a CPU profiler, and on a traced render run on the CPU at
32px, where every demodulated synthesis layer hands its demodulation to
kernel A. Run with `python -m pytest port_bench/tests -q`.
"""

import time
from types import SimpleNamespace

import pytest
import torch

from port_bench.harness import device as dev
from port_bench.harness import manifest
from gance_tpu_torch.utils import profiling

dev.program_environment()
torch.set_num_threads(4)
SEED = 2**31 + 4343
METRIC = "demod_folded_share.render"


def read(ctx):
    return manifest.layer_metric_reader(METRIC).read(ctx)


def counted(name, n):
    """Count `name` n times under a profiler (the counters record only then)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count(name, n)


def test_demod_folded_share_reads_the_program_counters(monkeypatch):
    profiling.reset()
    assert read(SimpleNamespace()) is None
    counted("ops.demod_folded", 34)
    assert read(SimpleNamespace()) == pytest.approx(100.0)
    counted("ops.demod_separate", 34)
    assert read(SimpleNamespace()) == pytest.approx(50.0)
    profiling.reset()
    # a program without the fold counts neither (the parent of the change
    # that adds it), or has no counters at all
    counted("runtime.rows_real", 45)
    assert read(SimpleNamespace()) is None
    profiling.reset()
    monkeypatch.delattr(profiling, "counters")
    assert read(SimpleNamespace()) is None


def test_traced_render_run_on_the_cpu_folds_every_demodulation():
    from port_bench.run import run_cell

    cell = manifest.load_cell("f1024-render")
    cell.config.update(resolution=32)
    assert METRIC in {m["name"] for m in cell.per_layer}
    profiling.reset()
    line = run_cell(cell, SEED, 1.0, True, "cpu", process_start=time.perf_counter())
    assert line["correct"]
    assert line["metrics"][METRIC]["value"] == 100.0
    counts = profiling.counters()
    assert counts["ops.demod_folded"] > 0 and "ops.demod_separate" not in counts
