"""
The general traffic generator. A mix (`traffic/<name>.json`) holds only
parameters; the sizes and arrivals it implies (run lengths, gaps, rows) are
drawn from the mix's own `shape_seed`, and a run's `--seed` draws only the
values (weights, z rows, targets). So every seed gives the same work.
"""

from typing import List, Tuple

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent host generator for draw stream `stream` of `seed`."""
    return np.random.default_rng([int(seed), int(stream)])


def z_rows(count: int, length: int, seed: int, stream: int = 1) -> np.ndarray:
    return rng(seed, stream).standard_normal((count, length), dtype=np.float32)


def run_lengths(mean: float, total: int, shape_seed: int) -> List[int]:
    """Geometric run lengths with the given mean, drawn from `shape_seed`
    until they cover `total` frames."""
    draw = np.random.default_rng(shape_seed)
    runs: List[int] = []
    while sum(runs) < total:
        runs.append(int(draw.geometric(1.0 / mean)))
    return runs


def switching_indices(total: int, networks: int, mean_run: float, shape_seed: int,
                      block_frames: int) -> np.ndarray:
    """Network indices that take turns in runs of geometric length: one
    block of runs covering `block_frames` frames, fixed by `shape_seed`,
    repeated to `total` frames."""
    runs = run_lengths(mean_run, block_frames, shape_seed)
    block = np.concatenate([np.full(run, k % networks) for k, run in enumerate(runs)])
    reps = -(-total // len(block))
    return np.tile(block, reps)[:total].astype(np.int64)


def open_loop_schedule(rate: float, seconds: float, rows_min: int, rows_max: int,
                       shape_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Poisson arrivals at `rate` a second over `seconds`: the gaps and the
    rows of each request (uniform in [rows_min, rows_max]) drawn from
    `shape_seed`, the gaps scaled to fill the window exactly. Returns (send
    times from the window's start, rows)."""
    draw = np.random.default_rng(shape_seed)
    load = seconds * rate
    count = int(round(load))
    gaps = draw.exponential(1.0, size=count)
    clock = np.cumsum(gaps) - gaps[0]
    clock *= load / gaps.sum()  # arrivals in units of expected requests
    rows = draw.integers(rows_min, rows_max + 1, size=count)
    return clock / rate, rows.astype(np.int64)
