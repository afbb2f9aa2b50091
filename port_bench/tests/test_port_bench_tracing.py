"""
The readers of the program's spans and counters (`harness/spans.py` and
the `runtime` metrics of layer_metrics/): on hand-made traces whose idle
gaps and spans overlap by known amounts, and on a traced render run on the
CPU at 32px. Run with `python -m pytest port_bench/tests -q`.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench.harness import device as dev
from port_bench.harness import manifest, spans, traffic
from port_bench.harness.trace import DeviceTrace
from gance_tpu_torch.synthesis.runtime import _bucket_size
from gance_tpu_torch.utils import profiling

dev.program_environment()
torch.set_num_threads(4)
SEED = 2**31 + 4242
DISPATCH = "runtime.dispatch_window"
RUNTIME_METRICS = ("idle_in_dispatch_share.render", "dispatch_ms_per_frame.render",
                   "pad_row_share.render")


def read(name, ctx):
    return manifest.layer_metric_reader(name).read(ctx)


def hand_made(host_ops):
    """A 100 ms window (in us) whose device is busy over [10, 40] and [60, 90]
    ms, so idle over [0, 10], [40, 60] and [90, 100] ms."""
    device = [("kernel_a", 10e3, 30e3), ("kernel_b", 60e3, 20e3), ("kernel_c", 75e3, 15e3)]
    return DeviceTrace(window=(0.0, 100e3), device_ops=device, host_ops=host_ops)


def test_interval_arithmetic():
    assert spans.merged([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3), (5, 10)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 1)], [(1, 2)]) == 0
    assert spans.overlap([], [(0, 5)]) == 0


def test_readers_on_a_hand_made_trace():
    # two dispatch spans: [5, 45] ms (idle inside: 5 + 5 ms) and [85, 120] ms,
    # clipped to the window at 100 ms (idle inside: 10 ms); an overlapping
    # span of another name and a nested child change nothing
    trace = hand_made([(DISPATCH, 5e3, 40e3), (DISPATCH, 85e3, 35e3),
                       ("runtime.forward", 6e3, 30e3), ("runtime.deliver", 0.0, 100e3)])
    ctx = SimpleNamespace(trace=trace, frames=50)
    assert read("device_idle_share.render", ctx) == pytest.approx(40.0)
    assert read("idle_in_dispatch_share.render", ctx) == pytest.approx(20.0)
    # 40 ms + 15 ms inside the window over 50 frames
    assert read("dispatch_ms_per_frame.render", ctx) == pytest.approx(55.0 / 50)
    # the same span twice (overlapping) counts once
    doubled = hand_made([(DISPATCH, 5e3, 40e3), (DISPATCH, 20e3, 25e3)])
    assert read("idle_in_dispatch_share.render",
                SimpleNamespace(trace=doubled, frames=1)) == pytest.approx(10.0)


def test_readers_give_none_without_the_span_or_the_trace():
    absent = SimpleNamespace(trace=hand_made([("runtime.forward", 0.0, 50e3)]), frames=10)
    assert read("idle_in_dispatch_share.render", absent) is None
    assert read("dispatch_ms_per_frame.render", absent) is None
    untraced = SimpleNamespace(trace=None, frames=10)
    assert read("idle_in_dispatch_share.render", untraced) is None
    assert read("dispatch_ms_per_frame.render", untraced) is None
    # no device operation: no device idle share of any kind
    no_device = DeviceTrace(window=(0.0, 100e3), host_ops=[(DISPATCH, 0.0, 50e3)])
    assert read("idle_in_dispatch_share.render",
                SimpleNamespace(trace=no_device, frames=1)) is None


def test_pad_row_share_reads_the_program_counters(monkeypatch):
    profiling.reset()
    assert read("pad_row_share.render", SimpleNamespace()) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("runtime.rows_real", 45)
        profiling.count("runtime.rows_dispatched", 48)
    assert read("pad_row_share.render", SimpleNamespace()) == pytest.approx(100 * 3 / 48)
    profiling.reset()
    # a program without the counters (the parent of the change that adds them)
    monkeypatch.delattr(profiling, "counters")
    assert read("pad_row_share.render", SimpleNamespace()) is None


def test_traced_render_run_on_the_cpu_reads_the_runtime_metrics(monkeypatch):
    from port_bench.run import run_cell

    cell = manifest.load_cell("f1024-render")
    cell.config.update(resolution=32)
    assert set(RUNTIME_METRICS) <= {m["name"] for m in cell.per_layer}
    seen = {}
    loader = manifest.layer_metric_reader

    def spying(name):
        module = loader(name)
        seen["ctx"] = None

        def spy(ctx):
            seen["ctx"] = ctx
            return module.read(ctx)

        return SimpleNamespace(read=spy)

    monkeypatch.setattr(manifest, "layer_metric_reader", spying)
    profiling.reset()
    line = run_cell(cell, SEED, 1.5, True, "cpu", process_start=time.perf_counter())
    assert line["correct"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    ctx = seen["ctx"]
    # the CPU ran no device operation: no device share is read, the rest is
    assert "device_idle_share.render" not in metrics
    assert "idle_in_dispatch_share.render" not in metrics
    assert metrics["dispatch_ms_per_frame.render"] > 0

    # the counters are the bucket arithmetic over the windows the stream
    # dispatched in the window (each of batch x lookahead frames)
    counts = profiling.counters()
    mix = cell.traffic
    size = mix["batch"] * mix["lookahead"]
    indices = traffic.switching_indices(counts["runtime.windows"] * size, mix["networks"],
                                        mix["mean_run_frames"], mix["shape_seed"],
                                        mix["block_frames"])
    real = dispatched = 0
    for start in range(0, len(indices), size):
        window = indices[start:start + size]
        for index in set(window.tolist()):
            count = int(np.sum(window == index))
            for first in range(0, count, mix["batch"]):
                rows = min(mix["batch"], count - first)
                real += rows
                dispatched += _bucket_size(rows, mix["batch"])
    assert (counts["runtime.rows_real"], counts["runtime.rows_dispatched"]) == (real, dispatched)
    assert metrics["pad_row_share.render"] == pytest.approx(100 * (1 - real / dispatched))
    assert counts["runtime.windows"] * size >= ctx.frames

    # the run's own spans under a device made busy for the first half of every
    # forward: the idle inside dispatch lies within the idle of the window
    forwards = [(s, d) for n, s, d in ctx.trace.host_ops if n == "runtime.forward"]
    assert forwards and len(forwards) == counts["runtime.forwards"]
    busy = DeviceTrace(window=ctx.trace.window, host_ops=ctx.trace.host_ops,
                       device_ops=[("kernel", s, d / 2) for s, d in forwards])
    busy_ctx = SimpleNamespace(trace=busy, frames=ctx.frames)
    inside = read("idle_in_dispatch_share.render", busy_ctx)
    assert 0 < inside <= read("device_idle_share.render", busy_ctx)
    profiling.reset()
