"""
The device trace of a `--trace 1` run: torch.profiler (CUPTI) over the
measured window, exported as a Chrome trace into the run's temporary
directory, read back and deleted. What the readers of layer_metrics/ take
from it: the device operations with their names, start and length; the
union of their intervals inside the window (busy seconds); the idle gaps,
named by the innermost host operation that was running in each.
"""

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

WINDOW_SPAN = "port_bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class DeviceTrace:
    """Intervals in microseconds on the profiler's clock."""

    window: Tuple[float, float]
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, dur
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def device_op_count(self) -> int:
        return len(self.device_ops)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.device_ops
                       if s + d > lo and s < hi)
        merged: List[Tuple[float, float]] = []
        for start, end in spans:
            if merged and start <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((start, end))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, cursor = [], lo
        for start, end in self.busy_intervals():
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if hi > cursor:
            gaps.append((cursor, hi))
        return gaps

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time, and the longest idle
        time summed by what the host was doing, as seconds."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device_ops:
            by_op[short_name(name)] += dur * 1e-6
        hosts = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in hosts]
        by_host: Dict[str, float] = defaultdict(float)
        for start, end in self.idle_gaps():
            mid = 0.5 * (start + end)
            label, best = "host outside any traced op", None
            # innermost host op that covers the gap's middle
            stop = bisect.bisect_right(starts, mid)
            for name, s, d in hosts[max(0, stop - 400):stop]:
                if s <= mid <= s + d and (best is None or d < best):
                    label, best = short_name(name), d
            by_host[label] += (end - start) * 1e-6
        return {
            "device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]],
        }


@dataclass
class TraceSummary:
    """A DeviceTrace read in another process (the serve cell's daemon),
    reduced to what the readers and the result line take."""

    busy_s: float
    window_s: float
    device_op_count: int
    summary_breakdown: Dict[str, List[List[Any]]]

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        return self.summary_breakdown


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespace noise and
    argument list, at most 96 characters."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:96]


def read_chrome_trace(path: str) -> DeviceTrace:
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    window: Optional[Tuple[float, float]] = None
    device, host = [], []
    for event in events:
        if event.get("ph") != "X":
            continue
        cat, name = event.get("cat", ""), event.get("name", "")
        start, dur = float(event.get("ts", 0.0)), float(event.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((name, start, dur))
        elif cat in HOST_CATEGORIES:
            if name == WINDOW_SPAN and cat == "user_annotation":
                window = (start, start + dur)
            else:
                host.append((name, start, dur))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return DeviceTrace(window=window, device_ops=device, host_ops=host)


@contextmanager
def profiled(enabled: bool, synchronize: Any) -> Iterator[Dict[str, Any]]:
    """Profile the enclosed window when `enabled`; on exit, after
    `synchronize()`, the holder's "trace" is the window's DeviceTrace."""
    holder: Dict[str, Any] = {"trace": None}
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        with record_function(WINDOW_SPAN):
            yield holder
            synchronize()
    fd, path = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder["trace"] = read_chrome_trace(path)
    finally:
        os.unlink(path)
