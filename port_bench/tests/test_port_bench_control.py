"""
The control on the card: each cell run as the configuration states it
comes out correct, and the program's TF32 tier (the nearest precision
below fp32 with TF32 off) comes out not correct, on fresh seeds at the
cells' own sizes with short windows. Needs a CUDA card; skips without one.
Run on the card with `python3 -m pytest port_bench/tests/test_port_bench_control.py -q`.
"""

import json
import subprocess
import sys

import pytest

from port_bench.harness.manifest import ROOT, load_manifest

CELLS = [w["name"] for w in load_manifest()["workloads"]]
SEEDS = "2147500001,2147500002"


def readings(cell: str, mode: str, seconds: float) -> list:
    out = subprocess.run([sys.executable, "port_bench/control.py", "--workload", cell,
                          "--mode", mode, "--seeds", SEEDS, "--seconds", str(seconds)],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass_and_the_tf32_control_fails(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is the program's TF32 tier on the card")
    seconds = 5.0 if cell.endswith("serve") else 2.0
    sound = readings(cell, "sound", seconds)
    control = readings(cell, "tf32", seconds)
    assert len(sound) == len(control) == 2
    assert all(r["correct"] for r in sound), sound
    assert not any(r["correct"] for r in control), control
