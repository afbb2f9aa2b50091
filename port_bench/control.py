"""
Readings that set a cell's limits (PERF.md gives them): the program as the
configuration states it ("sound"), and the control ("tf32"): the program's
own TF32 tier (GANCE_TPU_PRECISION=high), the nearest precision below the
stated fp32 with TF32 off, which must come out not correct. One process
reads many seeds; the benchmark's own runs never run this.

    python3 port_bench/control.py --workload f1024-render --mode tf32 --seeds 1,2,3 --seconds 3
"""

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench.harness import device as dev  # noqa: E402
from port_bench.harness import manifest  # noqa: E402

TIERS = {"sound": "highest", "tf32": "high"}


def readings(workload: str, mode: str, seeds: List[int], seconds: float,
             device: str = "cuda") -> List[Dict]:
    """Run the cell once per seed in this process under `mode`; each
    reading is the run's compared numbers and its verdict."""
    dev.program_environment(TIERS[mode])
    from port_bench.run import run_cell

    cell = manifest.load_cell(workload)
    out = []
    for seed in seeds:
        line = run_cell(cell, seed, seconds, False, device, process_start=time.perf_counter())
        out.append({"workload": workload, "mode": mode, "seed": seed,
                    "correct": line["correct"],
                    "numbers": {k: c["value"] for k, c in line["checks"].items()}})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=sorted(TIERS), required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args()
    dev.require_cards(1)
    for reading in readings(args.workload, args.mode,
                            [int(s) for s in args.seeds.split(",")], args.seconds):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
