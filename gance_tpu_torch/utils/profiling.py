"""
Tracing and per-stage throughput counters (the counterpart of
gance_tpu/utils/profiling.py).

  * `trace(log_dir)`: a context manager around torch.profiler (host ops, and
    the device's kernels when CUDA is present); on exit it writes a Chrome
    trace (`trace.<pid>.json`, viewable in Perfetto or chrome://tracing) into
    `log_dir`, with the spans of every thread of the process.
  * `span(name, **ids)` / `add_span` / `count(name, n)`: the program's own
    spans and counters. They record exactly while a torch profiler is active
    in the process (torch's process-wide `_is_profiler_enabled`, which
    `trace()` and any `torch.profiler.profile` set); otherwise `span` returns
    one shared null context after reading that flag, with no clock read and
    no `record_function`. `spans()` and `counters()` return snapshots.
  * `StageTimer` / `timed_iterator` / `timed_stage`: frames/s counters for
    pipeline stages; each logs rolling rates and a final summary dict, which
    is also appended as one JSON line to $GANCE_TPU_STAGE_STATS when that is
    set.
  * `start_memwatch`: a sampler of host RSS and device memory in use.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, TypeVar

import torch.autograd.profiler as _autograd_profiler

from gance_tpu_torch.utils.logging import LOGGER

_T = TypeVar("_T")

#: When set, every StageTimer.summary() also appends its dict as one JSON line here.
STAGE_STATS_ENV = "GANCE_TPU_STAGE_STATS"


#: Spans kept in memory per process; once full, the oldest go first.
SPAN_BUFFER = 1 << 18
#: The span `trace()` records on the profiler's thread as it starts: the one
#: span that is in the profiler's trace and in the buffer both, so the export
#: reads the offset between the two clocks from it.
CLOCK_MARK = "profiling.clock_mark"


class Span(NamedTuple):
    """One recorded span. Times are `now_us()`. `tid` is the native id of the
    thread it ran on, None for a span measured across threads (`add_span`);
    `parent` is the `id` of the span that caused it."""

    name: str
    tid: Optional[int]
    start_us: float
    end_us: float
    id: int
    parent: Optional[int]
    ids: Dict[str, Any]


def now_us() -> float:
    """The span clock: the host's monotonic clock in microseconds (a step
    of the wall clock moves no span). `trace()` maps it onto the trace's
    clock through `CLOCK_MARK`."""
    return time.monotonic_ns() / 1e3


class _Recorder:
    """The process's span buffer and counters (torch's profiler is
    process-wide, and so is what records beside it)."""

    def __init__(self) -> None:
        self.spans: "collections.deque[Span]" = collections.deque(maxlen=SPAN_BUFFER)
        self.counts: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def open_spans(self) -> List[int]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()


class _NullSpan:
    """What `span` returns while nothing records: one shared object."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Span:
    """A recording span: a `record_function` (so the profiler's own thread
    shows it in its trace) and an entry in the buffer (every thread)."""

    __slots__ = ("name", "ids", "id", "parent", "start", "annotation")

    def __init__(self, name: str, ids: Dict[str, Any]) -> None:
        self.name = name
        self.ids = ids

    def __enter__(self) -> "_Span":
        stack = _RECORDER.open_spans()
        self.parent = stack[-1] if stack else None
        self.id = next(_RECORDER.ids)
        stack.append(self.id)
        self.annotation = _autograd_profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start = now_us()
        return self

    def __exit__(self, *exc: Any) -> None:
        end = now_us()
        self.annotation.__exit__(*exc)
        _RECORDER.open_spans().pop()
        _RECORDER.spans.append(Span(self.name, threading.get_native_id(), self.start, end,
                                    self.id, self.parent, self.ids))


def span(name: str, **ids: Any) -> Any:
    """A context manager around one step of the program, named `name`, with
    identifiers `ids` (a request's id, a batch's). Its `id` is the parent a
    child names (None while nothing records)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NULL_SPAN
    return _Span(name, ids)


def add_span(name: str, start_us: float, end_us: float, parent: Optional[int] = None,
             **ids: Any) -> None:
    """Record a span measured elsewhere, on the `now_us()` clock: one that
    starts on one thread and ends on another (a request's wait)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    _RECORDER.spans.append(Span(name, None, start_us, end_us, next(_RECORDER.ids), parent, ids))


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while recording."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _RECORDER.lock:
        _RECORDER.counts[name] = _RECORDER.counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of the counters."""
    with _RECORDER.lock:
        return dict(_RECORDER.counts)


def spans() -> List[Span]:
    """A snapshot of the span buffer, oldest first."""
    return list(_RECORDER.spans)


def reset() -> None:
    """Empty the span buffer and the counters."""
    with _RECORDER.lock:
        _RECORDER.spans.clear()
        _RECORDER.counts.clear()


def _add_buffered_spans(path: Path, recorded: List[Span], mark_us: float,
                        own_tid: int) -> None:
    """Write into the Chrome trace at `path` the buffered spans of the threads
    the profiler did not record (it records annotations on its own thread,
    `own_tid`, only): one complete event per span on its thread's track, and
    a pair of async events for a span measured across threads. The offset
    between the span clock and the trace's is that of `CLOCK_MARK`, which
    started at `mark_us`. A trace with no such span is left as it is."""
    if all(item.tid == own_tid for item in recorded):
        return
    with open(path, encoding="utf-8") as handle:
        document = json.load(handle)
    events = document["traceEvents"]
    annotated = {e.get("tid") for e in events if e.get("cat") == "user_annotation"}
    mark = [e for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X"][0]
    offset = float(mark["ts"]) - mark_us
    pid = os.getpid()
    names = {t.native_id: t.name for t in threading.enumerate()}
    tracks = set()
    for item in recorded:
        args = dict(item.ids, span=item.id, parent=item.parent)
        start = item.start_us + offset
        if item.tid is None:
            common = {"cat": "program_span", "name": item.name, "id": item.id, "pid": pid,
                      "tid": pid}
            events.append(dict(common, ph="b", ts=start, args=args))
            events.append(dict(common, ph="e", ts=item.end_us + offset))
        elif item.tid not in annotated:
            tracks.add(item.tid)
            events.append({"ph": "X", "cat": "user_annotation", "name": item.name, "pid": pid,
                           "tid": item.tid, "ts": start, "dur": item.end_us - item.start_us,
                           "args": args})
    for tid in sorted(tracks):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"{names.get(tid, 'thread')} ({tid})"}})
    with open(path, "w", encoding="utf-8") as handle:
        json.dump(document, handle)


@contextlib.contextmanager
def trace(log_dir: Optional[Path]) -> Iterator[None]:
    """torch.profiler trace written to `log_dir` when one is given; no-op
    otherwise. The span buffer and counters start empty, and the trace gets
    the spans of every thread."""
    if log_dir is None:
        yield
        return
    import torch

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as profiler:
        reset()
        with span(CLOCK_MARK) as mark:
            pass
        yield
    path = log_dir / f"trace.{os.getpid()}.json"
    profiler.export_chrome_trace(str(path))
    _add_buffered_spans(path, spans(), mark.start, threading.get_native_id())
    LOGGER.info("Wrote profiler trace to %s", path)


@dataclass
class StageTimer:
    """Rolling throughput counter for one pipeline stage."""

    name: str
    log_every: int = 100
    _start: float = field(default_factory=time.monotonic)
    _last_log: float = field(default_factory=time.monotonic)
    _count: int = 0
    _count_at_last_log: int = 0
    _busy: float = 0.0

    def add_busy(self, seconds: float) -> None:
        """Accrue time spent *inside* this stage (vs. wall elapsed, which every
        stage of a serialized generator chain shares)."""
        self._busy += seconds

    def tick(self, n: int = 1) -> None:
        self._count += n
        if self._count - self._count_at_last_log >= self.log_every:
            now = time.monotonic()
            window = self._count - self._count_at_last_log
            rate = window / max(now - self._last_log, 1e-9)
            LOGGER.info(
                "[%s] %d items, %.2f items/sec (rolling)", self.name, self._count, rate
            )
            self._last_log = now
            self._count_at_last_log = self._count

    def summary(self) -> Dict[str, float]:
        elapsed = max(time.monotonic() - self._start, 1e-9)
        stats = {
            "stage": self.name,
            "count": self._count,
            "elapsed_sec": round(elapsed, 3),
            "rate_per_sec": round(self._count / elapsed, 3),
        }
        if self._busy:
            stats["busy_sec"] = round(self._busy, 3)
            stats["busy_rate_per_sec"] = round(self._count / max(self._busy, 1e-9), 3)
        LOGGER.info(
            "[%s] complete: %d items in %.2fs (%.2f items/sec)",
            self.name, self._count, elapsed, stats["rate_per_sec"],
        )
        sink = os.environ.get(STAGE_STATS_ENV)
        if sink:
            try:
                with open(sink, "a", encoding="utf-8") as handle:
                    handle.write(json.dumps(stats) + "\n")
            except OSError:  # stats are diagnostics; never kill the render
                LOGGER.warning("Could not append stage stats to %s", sink)
        return stats


def timed_iterator(name: str, iterator: Iterable[_T]) -> Iterator[_T]:
    """
    Wrap an iterator in a StageTimer: each item ticks, and the time spent inside
    ``next()`` accrues as the stage's busy time, i.e. the cumulative production
    cost of this stage plus everything upstream of it in the generator chain.
    The summary fires when the iterator exhausts or is closed.
    """
    timer = StageTimer(name)
    iterator = iter(iterator)
    try:
        while True:
            t0 = time.monotonic()
            try:
                item = next(iterator)
            except StopIteration:
                timer.add_busy(time.monotonic() - t0)
                return
            timer.add_busy(time.monotonic() - t0)
            timer.tick()
            yield item
    finally:
        # `zip` stops pulling one short of a peer stream's StopIteration, so a
        # stage wrapped here may never exhaust; the summary must also fire when
        # the generator is closed or finalized.
        timer.summary()


@contextlib.contextmanager
def timed_stage(name: str) -> Iterator[StageTimer]:
    """A StageTimer around a block: the block ticks it with the items it
    made; on exit the block's wall time is the stage's busy time and the
    summary fires."""
    timer = StageTimer(name)
    start = time.monotonic()
    try:
        yield timer
    finally:
        timer.add_busy(time.monotonic() - start)
        timer.summary()


def start_memwatch(path: Optional[Path] = None, interval_s: float = 5.0) -> bool:
    """
    A daemon thread appending one JSON line per `interval_s` to `path`
    (default: $GANCE_TPU_MEMWATCH) with wall time, host RSS (from
    /proc/self/status) and the device memory torch has allocated
    (`torch.cuda.memory_allocated`; null before CUDA is initialised or
    without CUDA). Idempotent; returns True when the watcher is running.
    Without a path or the env var it is a no-op.
    """
    target = path or (
        Path(os.environ["GANCE_TPU_MEMWATCH"])
        if os.environ.get("GANCE_TPU_MEMWATCH")
        else None
    )
    if target is None:
        return False
    started = getattr(start_memwatch, "_started", None)
    if started is not None:
        # One sampler per process: a second call with a different target
        # must not spawn a duplicate thread silently.
        if started != str(target):
            LOGGER.warning(
                "memwatch already sampling to %s; ignoring new target %s",
                started, target,
            )
        return started == str(target)

    import threading

    def rss_bytes() -> Optional[int]:
        try:
            with open("/proc/self/status", "r", encoding="ascii") as handle:
                for line in handle:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            return None
        return None

    def device_bytes() -> Optional[int]:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        return int(torch.cuda.memory_allocated()) or None

    start = time.time()

    def loop() -> None:
        while True:
            record = {
                "t": round(time.time() - start, 1),
                "rss": rss_bytes(),
                "hbm": device_bytes(),
            }
            try:
                with open(target, "a", encoding="ascii") as handle:
                    handle.write(json.dumps(record) + "\n")
            except OSError:
                pass
            time.sleep(interval_s)

    thread = threading.Thread(target=loop, name="memwatch", daemon=True)
    thread.start()
    start_memwatch._started = str(target)  # type: ignore[attr-defined]
    LOGGER.info("memwatch sampling RSS+device memory every %gs -> %s", interval_s, target)
    return True
