"""
Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a `workloads` entry of BENCHMARK.json at the root of the
checkout; its mix names the kind (`kinds/<kind>.py`) that drives the
program. With --trace 0 the line carries the cell's end-to-end metrics,
with --trace 1 its per-layer metrics (`layer_metrics/<name>.py`), read
from a profiled window. A run that finds fewer cards than the cell asks
for, or in which this process or the serve kind's daemon process holds a
module of JAX or of the JAX package once its window has closed, prints no
result and exits with 2 or 3.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.harness import device as dev  # noqa: E402
from port_bench.harness import manifest  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str,
             process_start: float = PROCESS_START) -> dict:
    """Drive the cell once and judge it: the pieces of the result line."""
    from port_bench.harness.compare import judge, limits_of

    kind = manifest.kind_module(cell.traffic["kind"])
    outcome = kind.run(cell, seed, seconds, trace, device)
    ok, checks = judge(outcome.numbers, limits_of(cell.name))
    metrics = {}
    breakdown = None
    if trace:
        from types import SimpleNamespace

        ctx = SimpleNamespace(**outcome.layer)
        for metric in cell.per_layer:
            value = manifest.layer_metric_reader(metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
        if ctx.trace is not None:
            breakdown = ctx.trace.breakdown()
    else:
        values = dict(outcome.e2e, setup_s=outcome.window_start - process_start)
        for metric in cell.end_to_end:
            metrics[metric["name"]] = {"value": float(values[metric["name"]]),
                                       "unit": metric["unit"]}
    record = dev.device_record(device, cell.chips, outcome.memory_peak_bytes)
    if trace and outcome.layer.get("trace") is not None:
        record["busy_s"] = outcome.layer["trace"].busy_s
        record["window_s"] = outcome.layer["trace"].window_s
    return {"correct": ok and outcome.failed == 0, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": record,
            "checks": checks, "breakdown": breakdown, "banned": outcome.banned_modules}


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.load_cell(args.workload)
    dev.program_environment()
    try:
        dev.require_cards(cell.chips)
    except dev.NoCard as error:
        print(f"port_bench: {error}", file=sys.stderr)
        return 2
    # no CUDA context here before the kind opens one: the serve kind's daemon
    # process is the only one on the card during its window
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = sorted(set(dev.banned_modules()) | set(line["banned"]))
    if found:
        print(f"port_bench: the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    from port_bench.harness.result import print_result

    print_result(line["correct"], line["attempted"], line["failed"], line["metrics"],
                 line["device"], line["checks"], line["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
