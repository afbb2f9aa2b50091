#!/usr/bin/env python3
"""
Repeated timings of the port's noise-blend pipeline, WAV in and AVI out, on
one GPU: the same renders as `chip_smoke.py` phase 8, each run `--repeats`
times in one process, so the spread between runs shows beside each number.
`--flagship` times the projection-file blend's renders of phase 9 instead.

    python3 tools/time_torch_pipeline.py [--seconds 4] [--repeats 3] [--trace] [--flagship]

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

With `--flagship`, each render is `chip_smoke.py`'s `flagship_render` over
phase 9's projection source (a projection file with h5py, else an in-memory
reader of the same 60 frames at 15 fps): fp32 at 1024px with no overlay, and
bf16 at 512px on the phase path with the README's overlay gates. Each run
prints `describe_flagship` (loading, audio features, render, each stage's
busy seconds). The flagship's host stages run after the device's last
event, so its traced render also prints the device's busy seconds over the
render's seconds.

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    FLAGSHIP_OVERLAY,
    SEED,
    describe_flagship,
    describe_render,
    flagship_render,
    host_findings,
    projection_source,
    run_render,
    set_phase,
    smoke_params,
)

CASES = (  # label, output side, compute dtype, phase path, egress
    ("fp32-1024-raw", 1024, "float32", False, "raw-spill"),
    ("bf16-512-phase-raw", 512, "bfloat16", True, "raw-spill"),
    ("fp32-1024-default-egress", 1024, "float32", False, "auto"),
)
SYNTHESIS_KERNEL = "bias_noise_lrelu"  # kernel A: the first of each synthesis forward
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
FLAGSHIP_CASES = (  # label, output side, compute dtype, phase path, overlay gates
    ("flagship-fp32-1024", 1024, "float32", False, None),
    ("flagship-bf16-512-phase-overlay", 512, "bfloat16", True, FLAGSHIP_OVERLAY),
)


def device_busy(trace_dir: Path) -> Tuple[float, float]:
    """(busy, span) in seconds from the first kernel of the first synthesis
    forward: busy is the union of kernel and copy intervals, span reaches
    the last device event; from the Chrome trace torch.profiler wrote."""
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
    return busy * 1e-6, (end - first) * 1e-6


def idle_share(trace_dir: Path) -> float:
    """1 - busy / span over the render."""
    busy, span = device_busy(trace_dir)
    return 1.0 - busy / span


def time_flagship(config, workdir: Path, paths, wav: Path, repeats: int, traced: bool,
                  card: str) -> None:
    """The flagship's renders of chip_smoke.py phase 9, repeated."""
    have_h5py, _ = host_findings()
    source = projection_source(config, workdir, have_h5py)
    out = workdir / "out.avi"
    for label, side, dtype, phase, overlay in FLAGSHIP_CASES:
        set_phase("on" if phase else "off")
        for run in range(repeats + int(traced)):
            trace_dir = workdir / f"trace-{label}" if run == repeats else None
            r = flagship_render(source, wav, paths, out, side, dtype, overlay, trace_dir)
            out.unlink()
            name = "traced" if trace_dir else f"run {run}"
            print(f"{label} {name}: {r['frames']} frames; {describe_flagship(r)}; on {card}",
                  flush=True)
            if trace_dir:
                busy, span = device_busy(trace_dir)
                print(f"{label} traced: device busy {busy:.3f} s over a render of "
                      f"{r['render']:.3f} s (idle share {1.0 - busy / r['render']:.3f}); from the "
                      f"first synthesis kernel to the last device event {span:.3f} s (idle share "
                      f"{1.0 - busy / span:.3f}); on {card}", flush=True)
    set_phase("off")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=4.0, help="length of the WAV")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--trace", action="store_true", help="one traced render per case")
    parser.add_argument("--flagship", action="store_true",
                        help="time the projection-file blend (phase 9) instead")
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
        if args.flagship:
            time_flagship(config, workdir, paths, wav, args.repeats, args.trace, card)
            return
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
