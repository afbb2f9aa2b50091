"""
The comparison that decides `correct`: the program's frames against the
plain reference's, each number beside its limit. The limits of a cell are
data, `limits/<cell>.json`, set from the readings that PERF.md gives.
"""

import json
from typing import Dict, List, Tuple

import numpy as np

from port_bench.harness.manifest import BENCH_DIR

Checks = Dict[str, Dict[str, float]]


def limits_of(cell: str) -> Dict[str, float]:
    return json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())["limits"]


def frame_numbers(got: List[np.ndarray], want: List[np.ndarray]) -> Dict[str, float]:
    """`px_off_share`: the share of uint8 values that differ from the
    reference's. A frame of the wrong shape reads as wholly off; nothing
    compared reads as no reading, which fails."""
    off, total = 0, 0
    for g, w in zip(got, want):
        total += w.size
        off += w.size if g.shape != w.shape else int(np.count_nonzero(g != w))
    return {"px_off_share": off / total if total else float("nan")}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Checks]:
    """Every number at or under its limit; a number that was not read fails."""
    checks = {name: {"value": numbers.get(name, float("nan")), "limit": limit}
              for name, limit in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
