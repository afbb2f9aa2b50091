"""
Find the knee of a serve cell once, by a sweep on the card: one daemon
process (harness/serve_child.py), then the cell's open loop at each rate in
turn. Per rate: requests, latency p50 / p95 / p99, frames per second
completed, rows per batch, and the backlog: the requests sent and not yet
answered, sampled every 0.25 s from `--skip` seconds into the window (the
batcher's batches grow to meet the load there) to the last send. Its growth
is the least-squares slope of that count in requests a second, given as a
share of the rate; its ratio is the mean count over the last third of those
samples over the mean over the first third. A queue that holds reads a
growth near 0 and a ratio near 1; one that does not keeps gaining
requests. The knee is the highest rate whose growth, and that of every
lower rate, stays under `GROWTH_LIMIT` of the rate; the cell's mix runs at
four fifths of it. The benchmark's own runs never run this.

    python3 port_bench/sweep.py --workload f1024-serve --rates 6,8,10,12 --seconds 40
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.harness import device as dev  # noqa: E402
from port_bench.harness import manifest, traffic  # noqa: E402

# a backlog that gains half a percent of the offered requests every second
# has not settled: at clearly light load (6-9 requests/s on the H100, 40 s
# measured) the growth read between -0.33% and -0.08% of the rate
GROWTH_LIMIT = 0.005
SAMPLE_S = 0.25


def backlog(sends, latencies, skip: float):
    """(growth in requests a second, last-third over first-third ratio) of
    the requests outstanding from `skip` to the last send."""
    import numpy as np

    done = np.sort(sends + latencies)  # inf: never answered
    grid = np.arange(skip, sends[-1], SAMPLE_S)
    outstanding = (np.searchsorted(np.sort(sends), grid, side="right")
                   - np.searchsorted(done, grid, side="right"))
    slope = float(np.polyfit(grid, outstanding, 1)[0])
    third = max(1, len(grid) // 3)
    ratio = float(outstanding[-third:].mean() / max(outstanding[:third].mean(), 1e-9))
    return slope, ratio


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True, help="requests a second, comma-separated")
    parser.add_argument("--seconds", type=float, default=40.0)
    parser.add_argument("--skip", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=2**31 + 99)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    import tempfile

    import numpy as np

    cell = manifest.load_cell(args.workload)
    mix, config = cell.traffic, cell.config
    kind = manifest.kind_module("serve")
    scratch = tempfile.mkdtemp(prefix="port_bench_sweep_")
    child = kind.Child(cell, args.seed, args.device, scratch)
    knee, holding = None, True
    try:
        port = int(child.expect("ready").split()[1])
        for rate in (float(r) for r in args.rates.split(",")):
            sends, rows = traffic.open_loop_schedule(rate, args.seconds, mix["rows_min"],
                                                     mix["rows_max"], mix["shape_seed"])
            z = traffic.z_rows(int(rows.sum()), config["latent_size"], args.seed)
            starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
            bodies = [json.dumps({"latents": z[s:s + r].tolist(), "format": mix["format"]}).encode()
                      for s, r in zip(starts, rows)]
            before = kind.get_json(port, "/stats")
            load = kind.drive(port, bodies, rows, sends, args.seconds, config["resolution"],
                              set(), mix.get("client_threads", 96))
            after = kind.get_json(port, "/stats")
            lat = load["latencies"] * 1e3
            growth, ratio = backlog(sends, load["latencies"], args.skip)
            holding = holding and growth < GROWTH_LIMIT * rate
            knee = rate if holding else knee
            print(json.dumps({
                "rate_per_s": rate, "requests": len(rows), "failed": int((~np.isfinite(lat)).sum()),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "frames_per_s": float(rows.sum() / load["window_s"]),
                "backlog_growth_per_s": growth, "backlog_growth_share": growth / rate,
                "backlog_ratio": ratio,
                "rows_per_batch": (after["frames"] - before["frames"])
                / max(1, after["batches"] - before["batches"]),
                "late_send_p99_ms": float(np.percentile(load["lateness"], 99)) * 1e3,
            }), flush=True)
            time.sleep(2.0)
        child.command("exit /dev/null", "bye")
    finally:
        child.close()
        (Path(scratch) / "cell.json").unlink()
        Path(scratch).rmdir()
    print(json.dumps({"knee_per_s": knee, "cell_rate_per_s": None if knee is None else 0.8 * knee,
                      "growth_limit_share": GROWTH_LIMIT}), flush=True)
    return 0


if __name__ == "__main__":
    dev.program_environment()
    sys.exit(main())
