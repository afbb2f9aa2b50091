#!/usr/bin/env python3
"""
Kernels A-F alone on the GPU, by `chip_smoke.py` phase 2's own functions:
each kernel at its path's shapes against its plain twin, its ms by CUDA
events beside the twin's, the library call's where one computes the same
function, and its bound (`port_bench/reference/bounds.py`), then the sums
per forward. Then the host microseconds per call of A-E's wrappers at
their smallest path shape, where the device is faster than the host: the
wrapper under `torch.inference_mode` (the serving path), under `no_grad`
and with grad enabled, its bare ctypes entry point called with the same
arguments, and a depthwise `F.conv2d` of the same plane as a yardstick; and
`upsample_2d` beside its tap analysis alone (the caller's share of B).

    python3 tools/time_torch_kernels.py [--kernels A,B,C,D,E,F] [--tree DIR] [--json PATH]

`--tree DIR` times the kernels of another checkout (its `gance_tpu_torch`,
built into its own build directory) with this checkout's phase 2, so that
a parent and a change compare in two calls of one command on one card.
Needs a CUDA GPU; exits 1 without one, and, as phase 2 does, when a kernel
leaves its twin's limits.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
HOST_CALLS, HOST_ROUNDS = 1000, 7


def host_us(fn, calls: int = HOST_CALLS, rounds: int = HOST_ROUNDS) -> float:
    """Microseconds per call on the host clock, the device drained at the end
    of each round: the median of `rounds` rounds of `calls` calls (the chip
    machine's host cores are shared, so single rounds spread)."""
    for _ in range(100):
        fn()
    per_round = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        per_round.append((time.perf_counter() - start) / calls * 1e6)
    return float(np.median(per_round))


def host_phase(S, config, gen: torch.Generator, kernels: str) -> dict:
    """Host microseconds per call of each wrapper of `kernels` among A-E (E
    at a small plane: its one path shape is bound by the device)."""
    from gance_tpu_torch.ops import upfirdn2d as U
    from gance_tpu_torch.ops.cuda import build
    from gance_tpu_torch.ops.cuda import fused_ops as K
    from gance_tpu_torch.ops.phase_block import fold_conv1_weights

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    shapes = S.path_shapes(config)
    a_shape = shapes["fused_bias_noise_lrelu"][0][0]
    x_a, noise, bias = randn(*a_shape), randn(1, 1, *a_shape[2:]), randn(a_shape[1])
    strength = torch.tensor(0.37, device="cuda")
    x_b = randn(*shapes["upsample2x_blur"][0][0])
    x_c = randn(*shapes["blur4_separable_pad11"][0][0])
    x_d = randn(*S.discriminator_shapes(config)[-1][0])
    b, c4, h, w = S.BATCH, 256, 8, 8
    x_e = randn(b, c4, h, w)
    w4 = fold_conv1_weights(randn(c4 // 4, c4 // 4, 3, 3) * 0.05)
    demod, nb = randn(b, c4).abs() + 0.5, randn(1, c4, h + 1, w + 1) * 0.1
    wrgb = randn(b, c4, 16) * 0.05
    # D's FIR as the resample plans hand it over: 16 row-major floats
    fir = tuple(float(v) for v in (np.outer(S.TAPS, S.TAPS) / 4.0).reshape(-1))
    wrappers = {  # letter: (library, call, input plane)
        "A": ("fused_bias_noise_lrelu",
              lambda: K.fused_bias_noise_lrelu(x_a, noise, bias, strength), x_a),
        "B": ("upsample2x_blur", lambda: K.upsample2x_blur(x_b, S.TAPS), x_b),
        "C": ("blur4_separable", lambda: K.blur4_separable_pad11(x_c, S.TAPS), x_c),
        "D": ("stencil_blur4_valid", lambda: K.stencil_blur4_valid(x_d, fir, (2, 2)), x_d),
        "E": ("phase_conv1_torgb", lambda: K.phase_conv1_torgb(x_e, w4, demod, nb, wrgb), x_e),
    }
    results = {}
    for letter, (library, call, x) in wrappers.items():
        if letter not in kernels:
            continue
        real = build.load(library)
        seen = []

        def record(*a, real=real, seen=seen):
            seen.append(a)
            return real(*a)

        build._LOADED[library] = record
        try:
            with torch.inference_mode():
                kept = call()  # keeps the output the recorded pointers write to
        finally:
            build._LOADED[library] = real
        bare_args = seen[0]
        c = x.shape[1]
        kt = torch.full((c, 1, 4, 4), 1.0 / 16, device="cuda")
        with torch.inference_mode():
            served = host_us(call)
            conv = host_us(lambda: F.conv2d(x, kt, padding=1, groups=c))
        with torch.no_grad():
            no_grad = host_us(call)
        grad = host_us(call)
        bare = host_us(lambda: real(*bare_args))
        name = f"{letter} {S.KERNELS[letter]}"
        results[name] = {"shape": list(x.shape), "inference_mode": served, "no_grad": no_grad,
                         "grad_enabled": grad, "bare_ctypes": bare, "depthwise_conv2d": conv}
        print(f"host us per call, {name} at {tuple(x.shape)}: wrapper inference_mode "
              f"{served:.2f}, no_grad {no_grad:.2f}, grad enabled {grad:.2f}; bare ctypes "
              f"{bare:.2f}; depthwise conv2d {conv:.2f}", flush=True)
        del kept
    if "B" in kernels:
        with torch.inference_mode():
            caller = host_us(lambda: U.upsample_2d(x_b))
        tap = host_us(lambda: U._plan("up", S.TAPS, (2, 1.0), U._upsample_plan))
        results["upsample_2d"] = {"inference_mode": caller, "tap_analysis": tap}
        print(f"host us per call, upsample_2d at {tuple(x_b.shape)}: {caller:.2f} under "
              f"inference_mode; its tap analysis alone {tap:.2f}", flush=True)
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", default="A,B,C,D,E,F",
                        help="comma-separated subset of A,B,C,D,E,F")
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="checkout whose gance_tpu_torch is timed (default: this one)")
    parser.add_argument("--json", type=Path, default=None, help="also write the records here")
    args = parser.parse_args()
    kernels = args.kernels.upper().replace(",", "")
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S  # this checkout's phase 2, whichever tree it times

    if not set(kernels) <= set(S.KERNELS):
        parser.error(f"--kernels {args.kernels}: expected letters of {','.join(S.KERNELS)}")
    sys.path.insert(0, str(args.tree.resolve()))
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops import precision
    from gance_tpu_torch.ops.cuda import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; timing the kernels of {build.__file__}", flush=True)
    precision.apply_conv_precision()
    print(f"kernel build: {build.build_all():.1f} s", flush=True)
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {log.stem}: {line.strip()}")

    config = GeneratorConfig()
    gen = torch.Generator(device="cuda").manual_seed(S.SEED)
    records = S.kernel_phase(config, gen, kernels)
    host = host_phase(S, config, gen, kernels)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "tree": str(args.tree), "kernels": records,
                                         "host_us": host}, indent=1))


if __name__ == "__main__":
    main()
