#!/usr/bin/env python3
"""
Repeated timings of the port's noise-blend pipeline, WAV in and AVI out, on
one GPU: the same renders as `chip_smoke.py` phase 8, each run `--repeats`
times in one process, so the spread between runs shows beside each number.

    python3 tools/time_torch_pipeline.py [--seconds 4] [--repeats 3] [--trace]

Two config-f 1024px networks with seeded random weights (`chip_smoke.py`'s
`smoke_params`) are written with `save_generator_pickle`, and a percussive
WAV with `fabricate_percussive_wav`. Each render is `chip_smoke.py`'s
`run_render` (`noise_blend_api` at vector length 512, 30 fps, alpha 0.25):
fp32 at 1024px with the raw egress (GANCE_TPU_EGRESS=raw-spill), bf16 at
512px on the phase path with the raw egress, and fp32 at 1024px with the
host's default egress. Each run prints `chip_smoke.py`'s `describe_render`:
its wall seconds split into network loading, audio features and synthesis
plus write, the synthesis stream's own seconds, and frames/s. `--trace`
adds one traced render of each case (`trace_dir`) and prints the device's
idle share over the render: 1 - (the union of kernel and copy intervals) /
(the span from the first kernel of the first synthesis forward to the last
device event).

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import SEED, describe_render, run_render, smoke_params  # noqa: E402

CASES = (  # label, output side, compute dtype, phase path, egress
    ("fp32-1024-raw", 1024, "float32", False, "raw-spill"),
    ("bf16-512-phase-raw", 512, "bfloat16", True, "raw-spill"),
    ("fp32-1024-default-egress", 1024, "float32", False, "auto"),
)
SYNTHESIS_KERNEL = "bias_noise_lrelu"  # kernel A: the first of each synthesis forward
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_share(trace_dir: Path) -> float:
    """1 - busy / span over the render, from the Chrome trace torch.profiler wrote."""
    (trace,) = trace_dir.glob("trace.*.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENTS]
    first = min(e["ts"] for e in events if SYNTHESIS_KERNEL in e.get("name", ""))
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["ts"] >= first)
    busy, end = 0.0, first
    for lo, hi in intervals:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return 1.0 - busy / (end - first)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=4.0, help="length of the WAV")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--trace", action="store_true", help="one traced render per case")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)

    from gance_tpu_torch.audio.io import fabricate_percussive_wav
    from gance_tpu_torch.media import native
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops.cuda import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}; kernel build {build.build_all():.1f} s", flush=True)
    native.build_library()
    config = GeneratorConfig()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        workdir = Path(tmp)
        paths = []
        for i in range(2):  # the networks of chip_smoke.py's phase 3
            paths.append(workdir / f"{i}_net.pkl")
            save_generator_pickle(smoke_params(SEED + 10 * i, config), paths[-1])
        wav = fabricate_percussive_wav(workdir / "song.wav", seconds=args.seconds)
        out = workdir / "out.avi"
        for label, side, dtype, phase, egress in CASES:
            for run in range(args.repeats):
                r = run_render(wav, paths, out, side, dtype, phase, egress)
                out.unlink()
                print(f"{label} run {run}: {r['frames']} frames; {describe_render(r)}; on {card}",
                      flush=True)
            if args.trace:
                trace_dir = workdir / f"trace-{label}"
                r = run_render(wav, paths, out, side, dtype, phase, egress, trace_dir)
                out.unlink()
                print(f"{label} traced: synthesis and write {r['render']:.3f} s, device idle share "
                      f"over the render {idle_share(trace_dir):.3f}; on {card}", flush=True)


if __name__ == "__main__":
    main()
