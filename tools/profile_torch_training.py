#!/usr/bin/env python3
"""
Where the GPU time of the port's 1024px config-f train step goes.

Runs `make_train_step` of gance_tpu_torch on random config-f params (seeded)
with seeded images in [-1, 1] at one batch size and compute dtype, with R1
and path length on every step or on none, then:
  * the time per step by CUDA events, unprofiled, and the peak memory;
  * torch.profiler over a few steps: device time summed per kernel name and
    per family (the port's kernels, convolutions, elementwise, copies,
    other), as ms per step and as a share of the device time, with each of
    the port's kernels apart;
  * the device's idle share: 1 - (device time per step / time per step).

    python3 tools/profile_torch_training.py [--batch 4] [--dtype float32|bfloat16] \\
        [--regularize none|r1|pl|both] [--steps 3]

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import collections
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_torch_synthesis import family  # noqa: E402

PORT_KERNELS = ("bias_noise_lrelu", "upsample2x_blur", "blur4_kernel", "stencil_kernel")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--regularize", choices=("none", "r1", "pl", "both"), default="none",
                        help="which lazy regularizers run on every profiled step")
    parser.add_argument("--steps", type=int, default=3, help="timed and profiled steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)

    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel import training as T

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    config = GeneratorConfig()
    # an interval of 1 runs the regularizer on every step; a huge one after step 0 never
    never = 10**9
    tc = T.TrainingConfig(
        compute_dtype=args.dtype,
        r1_interval=1 if args.regularize in ("r1", "both") else never,
        pl_interval=1 if args.regularize in ("pl", "both") else never,
    )
    state = T.init_training_state(0, config, tc, device="cuda")
    state.step = 1  # step 0 would run both regularizers whatever the intervals
    step_fn = T.make_train_step(config, tc)
    rng = np.random.RandomState(0)
    reals = torch.from_numpy(rng.uniform(-1, 1, (args.batch, config.resolution, config.resolution, 3))
                             .astype(np.float32)).cuda()

    def run() -> None:
        nonlocal state
        draws = T.draw_step(0, state.step, args.batch, config, tc, "cuda")
        state, _ = step_fn(state, reals, draws)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        run()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / args.steps
    peak = torch.cuda.max_memory_allocated() / 2**30

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    per_kernel = collections.Counter()
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[event.key] += event.self_device_time_total / 1e3 / args.steps
    device_ms = sum(per_kernel.values())
    print(f"{card}; torch {torch.__version__}; train step batch {args.batch} {args.dtype} "
          f"{config.resolution}px config-f, regularizers {args.regularize}")
    print(f"time per step (CUDA events, unprofiled): {wall_ms:.3f} ms; peak memory {peak:.2f} GiB")
    if device_ms == 0:
        print("the profiler recorded no device time")
        sys.exit(1)
    print(f"device time per step (profiler): {device_ms:.3f} ms; idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}")
    families = collections.Counter()
    port = collections.Counter()
    for name, ms in per_kernel.items():
        families[family(name)] += ms
        for key in PORT_KERNELS:
            if key in name:
                port[key] += ms
    for label, ms in families.most_common():
        print(f"family {label}: {ms:.3f} ms per step ({ms / device_ms:.3f})")
    for key, ms in port.most_common():
        print(f"port kernel {key}: {ms:.3f} ms per step ({ms / device_ms:.3f})")
    for name, ms in per_kernel.most_common(15):
        print(f"kernel {ms:.3f} ms ({ms / device_ms:.3f}) {family(name)}: {name[:110]}")


if __name__ == "__main__":
    main()
