"""
Tracing and per-stage throughput counters (the counterpart of
gance_tpu/utils/profiling.py).

  * `trace(log_dir)`: a context manager around torch.profiler (host ops, and
    the device's kernels when CUDA is present); on exit it writes a Chrome
    trace (`trace.<pid>.json`, viewable in Perfetto or chrome://tracing) into
    `log_dir`.
  * `StageTimer` / `timed_iterator` / `timed_stage`: frames/s counters for
    pipeline stages; each logs rolling rates and a final summary dict, which
    is also appended as one JSON line to $GANCE_TPU_STAGE_STATS when that is
    set.
  * `start_memwatch`: a sampler of host RSS and device memory in use.
"""

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, TypeVar

from gance_tpu_torch.utils.logging import LOGGER

_T = TypeVar("_T")

#: When set, every StageTimer.summary() also appends its dict as one JSON line here.
STAGE_STATS_ENV = "GANCE_TPU_STAGE_STATS"


@contextlib.contextmanager
def trace(log_dir: Optional[Path]) -> Iterator[None]:
    """torch.profiler trace written to `log_dir` when one is given; no-op otherwise."""
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
        yield
    path = log_dir / f"trace.{os.getpid()}.json"
    profiler.export_chrome_trace(str(path))
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
