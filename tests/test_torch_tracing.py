"""
The port's spans and counters (gance_tpu_torch/utils/profiling.py) on the
CPU: with no profiler a span is the one shared null object and nothing is
recorded; under a profiler the render stream's spans nest as the runtime
runs them, none of them spans a frame handed to the caller, and its counters
follow `_bucket_size`; under `trace()` the batcher's and the daemon's
threads reach the exported Chrome trace with their thread ids, inside the
profiled window, sharing request ids, each queue wait under its batch; and
/stats and /metrics carry the queue-wait quantiles.
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gance_tpu_torch.serving.batcher import DynamicBatcher
from gance_tpu_torch.serving.daemon import SynthesisDaemon
from gance_tpu_torch.synthesis.runtime import FakeSynthesisNetwork, MultiNetwork, _bucket_size
from gance_tpu_torch.utils import profiling

VECTOR = 8
# network index per frame: runs of 5, 11, 3, 1 and 20 frames over three networks
INDICES = np.repeat([0, 1, 0, 2, 1], [5, 11, 3, 1, 20])


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.reset()
    yield
    profiling.reset()


def fakes(count: int = 3):
    return MultiNetwork.from_networks(
        [FakeSynthesisNetwork(resolution=4, expected_vector_length=VECTOR) for _ in range(count)])


def frames(n: int) -> np.ndarray:
    return np.random.RandomState(3).randn(n, VECTOR).astype(np.float32)


def expected_counts(indices: np.ndarray, batch: int, lookahead: int) -> dict:
    """What the stream dispatches: per window, per network in order of first
    appearance, full batches and a remainder bucketed by `_bucket_size`."""
    real = dispatched = forwards = windows = 0
    window = batch * lookahead
    for start in range(0, len(indices), window):
        chunk = indices[start:start + window]
        windows += 1
        for index in dict.fromkeys(chunk.tolist()):
            count = int(np.sum(chunk == index))
            for first in range(0, count, batch):
                rows = min(batch, count - first)
                real += rows
                dispatched += _bucket_size(rows, batch)
                forwards += 1
    return {"runtime.rows_real": real, "runtime.rows_dispatched": dispatched,
            "runtime.forwards": forwards, "runtime.windows": windows}


def test_no_profiler_no_clock_read_no_record_function_no_spans(monkeypatch):
    def forbidden(*_args, **_kwargs):
        raise AssertionError("called with no profiler active")

    monkeypatch.setattr(profiling, "now_us", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b", request=1) is profiling.NULL_SPAN
    with profiling.span("a", request=1) as opened:
        assert opened.id is None
    profiling.add_span("a", 0.0, 1.0, request=1)
    profiling.count("a", 3)
    got = list(fakes().synthesize_stream(frames(len(INDICES)), INDICES, batch_size=4,
                                         lookahead=2))
    assert len(got) == len(INDICES)
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.mark.parametrize("batch,lookahead", [(4, 2), (8, 2), (8, 1)])
def test_stream_spans_nest_and_counters_follow_the_bucket_arithmetic(batch, lookahead):
    stream = fakes().synthesize_stream(frames(len(INDICES)), INDICES, batch_size=batch,
                                       lookahead=lookahead)
    handed = []
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        for _frame in stream:
            handed.append(profiling.now_us())
            time.sleep(0.0005)
    assert profiling.counters() == expected_counts(INDICES, batch, lookahead)
    recorded = profiling.spans()
    by_id = {s.id: s for s in recorded}
    names = [s.name for s in recorded]
    windows = expected_counts(INDICES, batch, lookahead)["runtime.windows"]
    assert names.count("runtime.dispatch_window") == windows
    assert names.count("runtime.await_window") == names.count("runtime.deliver") == windows
    for item in recorded:
        assert item.tid == threading.get_native_id() and item.start_us <= item.end_us
        if item.name in ("runtime.forward", "runtime.host_copy"):
            assert by_id[item.parent].name == "runtime.dispatch_window"
        else:
            assert item.parent is None
        # no span is open while the caller holds a frame
        assert not any(item.start_us < t < item.end_us for t in handed), item.name


def test_counting_is_safe_across_threads():
    with profile(activities=[ProfilerActivity.CPU]):
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda _: [profiling.count("n") for _ in range(2000)], range(8)))
    assert profiling.counters() == {"n": 16000}


def post(port: int, body: dict) -> bytes:
    request = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                     data=json.dumps(body).encode())
    with urllib.request.urlopen(request, timeout=60) as response:
        return response.read()


def get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as response:
        return response.read()


def test_trace_holds_every_threads_spans_with_request_ids_and_batch_parents(tmp_path):
    network = FakeSynthesisNetwork(resolution=4, expected_vector_length=VECTOR)
    with SynthesisDaemon(network, port=0, max_batch=8, max_delay_ms=20) as daemon:
        with profiling.trace(tmp_path):
            with ThreadPoolExecutor(6) as pool:
                list(pool.map(lambda k: post(daemon.port, {"count": 1 + k % 5, "seed": k}),
                              range(12)))
            time.sleep(0.01)
            torch.ones(2) + 1  # an operator of the profiler's own after the last span
        batcher = daemon.batcher
        threads = {"dispatch": batcher._dispatch_thread.native_id,
                   "fetch": batcher._fetch_thread.native_id}
    events = json.loads(next(tmp_path.glob("trace.*.json")).read_text())["traceEvents"]
    main = threading.get_native_id()
    mark = next(e for e in events if e.get("name") == profiling.CLOCK_MARK)
    end = max(e["ts"] + e["dur"] for e in events if e.get("cat") == "cpu_op" and e["tid"] == main)
    spans = [e for e in events if e.get("ph") == "X" and e["name"].startswith("serving.")]
    for event in spans:
        assert mark["ts"] <= event["ts"] and event["ts"] + event["dur"] <= end, event
    tids = {e["name"]: e["tid"] for e in spans}
    for name in ("await_request", "linger", "assemble", "issue", "backpressure"):
        assert tids[f"serving.batcher.{name}"] == threads["dispatch"], name
    for name in ("await_frames", "resolve"):
        assert tids[f"serving.batcher.{name}"] == threads["fetch"], name
    handler = {e["tid"] for e in spans if e["name"].startswith("serving.http.")}
    assert handler and not handler & {main, *threads.values()}
    named = {e["tid"] for e in events if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {threads["dispatch"], threads["fetch"]} | handler <= named

    # every request: its four handler spans, and its request and queue-wait
    # spans (measured across threads) under the batch that took its rows
    issues = {e["args"]["span"]: e for e in spans if e["name"] == "serving.batcher.issue"}
    begins = [e for e in events if e.get("ph") == "b"]
    ends = {e["id"]: e for e in events if e.get("ph") == "e"}
    requests = {e["args"]["request"] for e in spans if e["name"] == "serving.http.parse"}
    assert len(requests) == 12
    for request in requests:
        steps = [e["name"] for e in spans if e["args"].get("request") == request]
        assert sorted(steps) == ["serving.http.await_result", "serving.http.encode",
                                 "serving.http.parse", "serving.http.write"]
        own = {e["name"]: e for e in begins if e["args"]["request"] == request}
        assert set(own) == {"serving.request", "serving.queue_wait"}
        wait, whole = own["serving.queue_wait"], own["serving.request"]
        issue = issues[wait["args"]["parent"]]
        assert whole["ts"] == wait["ts"] <= issue["ts"] + 1.0
        assert ends[wait["id"]]["ts"] <= ends[whole["id"]]["ts"] <= end
    assert len(begins) == len(ends) == 24


def test_stats_and_metrics_carry_the_queue_wait_quantiles():
    network = FakeSynthesisNetwork(resolution=4, expected_vector_length=VECTOR)
    with SynthesisDaemon(network, port=0, max_batch=8, max_delay_ms=0) as daemon:
        assert "queue_wait_p50_ms" not in daemon.batcher.stats()
        for k in range(4):
            post(daemon.port, {"count": 2, "seed": k})
        stats = json.loads(get(daemon.port, "/stats"))
        metrics = get(daemon.port, "/metrics").decode()
    assert 0 <= stats["queue_wait_p50_ms"] <= stats["queue_wait_p95_ms"]
    assert stats["queue_wait_p95_ms"] <= stats["latency_p99_ms"]
    for quantile in ("p50", "p95"):
        line = next(l for l in metrics.splitlines()
                    if l.startswith(f"gance_serving_queue_wait_{quantile}_seconds "))
        assert float(line.split()[1]) == pytest.approx(
            stats[f"queue_wait_{quantile}_ms"] / 1e3, abs=1e-5)


def test_batcher_queue_wait_ends_at_the_batch_of_the_last_rows():
    """A request split over two device batches waits until the second."""
    network = FakeSynthesisNetwork(resolution=4, expected_vector_length=VECTOR)
    with profile(activities=[ProfilerActivity.CPU]):
        with DynamicBatcher(network, max_batch=8, max_delay_ms=0) as batcher:
            batcher.submit(frames(20), request_id=77).result(timeout=30)
    recorded = profiling.spans()
    issues = [s for s in recorded if s.name == "serving.batcher.issue"]
    assert [s.ids["batch"] for s in issues] == [1, 2, 3]
    (wait,) = [s for s in recorded if s.name == "serving.queue_wait"]
    assert wait.ids == {"request": 77} and wait.tid is None
    assert wait.parent == issues[-1].id


def test_trace_leaves_its_export_alone_when_every_span_is_the_profilers_own(tmp_path,
                                                                          monkeypatch):
    """Spans of the profiler's own thread are in the trace already, through
    record_function: the export is not read back or rewritten for them."""
    def forbidden(*_args, **_kwargs):
        raise AssertionError("the exported trace was read back")

    with profiling.trace(tmp_path):
        list(fakes().synthesize_stream(frames(len(INDICES)), INDICES, batch_size=4,
                                       lookahead=2))
        monkeypatch.setattr(profiling.json, "load", forbidden)
    monkeypatch.undo()
    events = json.loads(next(tmp_path.glob("trace.*.json")).read_text())["traceEvents"]
    main = threading.get_native_id()
    dispatched = [e for e in events if e.get("name") == "runtime.dispatch_window"]
    assert len(dispatched) == expected_counts(INDICES, 4, 2)["runtime.windows"]
    assert all(e["tid"] == main and e["cat"] == "user_annotation" for e in dispatched)


def test_batcher_times_do_not_follow_the_wall_clock(monkeypatch):
    """Latency and queue wait are read on the monotonic span clock: a wall
    clock stepped back an hour on every read moves neither."""
    stepped = iter(range(10**19, 0, -3600 * 10**9))
    monkeypatch.setattr(time, "time_ns", lambda: next(stepped))
    network = FakeSynthesisNetwork(resolution=4, expected_vector_length=VECTOR)
    with DynamicBatcher(network, max_batch=8, max_delay_ms=0) as batcher:
        for k in range(3):
            batcher.submit(frames(2 + k)).result(timeout=30)
        stats = batcher.stats()
    for key in ("queue_wait_p50_ms", "queue_wait_p95_ms", "latency_p50_ms", "latency_p99_ms"):
        assert 0 <= stats[key] < 30e3, key
