#!/usr/bin/env python3
"""
Where the GPU time of the port's 1024px config-f frame synthesis goes.

Runs `SynthesisNetwork.device_images_from_vectors` of gance_tpu_torch on a
random config-f network (seeded) at one batch size and compute dtype, then:
  * the time per batch by CUDA events, unprofiled;
  * torch.profiler over a few batches: device time summed per kernel name and
    per family (the port's kernels, convolutions, elementwise, copies, other),
    as ms per batch and as a share of the device time;
  * the device's idle share: 1 - (device time per batch / time per batch).

    python3 tools/profile_torch_synthesis.py [--batch 8] [--dtype float32|bfloat16] \
        [--phase off|on]

`--phase on` runs the top block in phase space (GANCE_TPU_PHASE1024=on), with
its Conv1 + epilogue + ToRGB in kernel E.

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FAMILIES = (
    ("port kernels", ("bias_noise_lrelu", "upsample2x_blur", "blur4_kernel", "stencil_kernel",
                      "phase_f32_kernel", "phase_bf16_kernel")),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "cutlass", "sm90", "sm80", "winograd")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "where", "clamp", "floor")),
    ("copy", ("memcpy", "memset", "copy")),
)


def family(name: str) -> str:
    lowered = name.lower()
    for label, keys in FAMILIES:
        if any(k in lowered for k in keys):
            return label
    return "other"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--batches", type=int, default=3, help="profiled batches")
    parser.add_argument("--phase", choices=("off", "on"), default="off",
                        help="the polyphase top block (GANCE_TPU_PHASE1024)")
    args = parser.parse_args()
    os.environ["GANCE_TPU_PHASE1024"] = args.phase
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)

    from gance_tpu_torch.models.stylegan2 import GeneratorConfig, init_generator_params
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    config = GeneratorConfig()
    net = SynthesisNetwork(
        params=init_generator_params(0, config), config=config,
        compute_dtype=getattr(torch, args.dtype),
    )
    z = np.random.RandomState(0).standard_normal((args.batch, config.latent_size)).astype(np.float32)
    run = lambda: net.device_images_from_vectors(z)  # noqa: E731
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.batches):
        run()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / args.batches

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.batches):
            run()
        torch.cuda.synchronize()
    per_kernel = collections.Counter()
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[event.key] += event.self_device_time_total / 1e3 / args.batches
    device_ms = sum(per_kernel.values())
    print(f"{card}; torch {torch.__version__}; batch {args.batch} {args.dtype} "
          f"{config.resolution}px config-f, phase path {args.phase}")
    print(f"time per batch (CUDA events, unprofiled): {wall_ms:.3f} ms = "
          f"{args.batch / wall_ms * 1e3:.2f} frames/s")
    if device_ms == 0:
        print("the profiler recorded no device time")
        sys.exit(1)
    print(f"device time per batch (profiler): {device_ms:.3f} ms; idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}")
    families = collections.Counter()
    for name, ms in per_kernel.items():
        families[family(name)] += ms
    for label, ms in families.most_common():
        print(f"family {label}: {ms:.3f} ms per batch ({ms / device_ms:.3f})")
    for name, ms in per_kernel.most_common(12):
        print(f"kernel {ms:.3f} ms ({ms / device_ms:.3f}) {family(name)}: {name[:110]}")


if __name__ == "__main__":
    main()
