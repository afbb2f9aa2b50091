"""
What a kind's run hands back, and the result line the harness prints.
"""

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Outcome:
    """One run of a cell, as its kind measured it."""

    window_start: float  # time.perf_counter() when the window opened
    e2e: Dict[str, float]  # end-to-end metric -> value (setup_s is the harness's)
    attempted: int
    failed: int
    numbers: Dict[str, float]  # the numbers that decide `correct`
    memory_peak_bytes: int
    # top-level names of JAX or the JAX package held, once the window had
    # closed, by a process of the run other than the one that prints the line
    banned_modules: List[str] = field(default_factory=list)
    # what the per-layer readers read: "trace" (DeviceTrace or None), "config",
    # "mix", and the kind's own spans and counters
    layer: Dict[str, Any] = field(default_factory=dict)


class Reservoir:
    """A uniform sample of `size` items out of a stream of unknown length,
    drawn from `rng` (Algorithm R); items are copied when kept."""

    def __init__(self, size: int, rng: np.random.Generator) -> None:
        self.size, self.rng = size, rng
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, key: Any, item: np.ndarray) -> None:
        if self.seen < self.size:
            self.items.append((key, np.array(item)))
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.items[slot] = (key, np.array(item))
        self.seen += 1


def _number(value: float) -> Optional[float]:
    """A reading as JSON takes it: no reading is null."""
    return float(value) if np.isfinite(value) else None


def print_result(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict[str, Any]],
                 device: Dict[str, Any], checks: Dict[str, Dict[str, float]],
                 breakdown: Optional[Dict[str, Any]] = None) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the one JSON line on standard output (checks last)."""
    checks = {name: {"value": _number(c["value"]), "limit": c["limit"]} for name, c in checks.items()}
    for name, check in checks.items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
