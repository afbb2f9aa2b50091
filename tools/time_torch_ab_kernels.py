#!/usr/bin/env python3
"""
Kernels A (`fused_bias_noise_lrelu`) and B (`upsample2x_blur`) alone on the
GPU, at every shape the 1024px config-f synthesis path gives them at batch 8,
in fp32 and bf16, and the host time per call of all five kernel wrappers:

  * A: each noise-carrying layer's epilogue, (8, C, r, r) for r = 4 .. 1024,
    with the constant noise (1, 1, r, r); and training's per-sample noise at
    (4, 64, 1024, 1024);
  * B: the ToRGB skip upsample, (8, 3, r/2, r/2) for r = 8 .. 1024.

For each shape it checks the kernel against its plain twin (bit for bit,
atol 0) and prints the kernel's ms by CUDA events, the bound (each input byte
read once and each output byte written once at 3.35 TB/s, as `chip_smoke.py`
phase 2 counts it), the bound's share of the kernel time and the achieved
GB/s; for B also the depthwise stride-2 `conv_transpose2d` that computes the
same function (the yardstick, not used by the port). Then the sums per
synthesis forward.

Host time per call (`time.perf_counter` over a few thousand calls, ending in
a synchronize, at each wrapper's smallest path shape, where the device is
faster than the host): the public wrapper under `torch.inference_mode` (the
serving path) and with grad enabled, its bare ctypes entry point called with
the same arguments, and a depthwise `F.conv2d` of the same plane as a
yardstick; and `upsample_2d`'s time beside B's wrapper, whose difference is
the caller's tap analysis.

    python3 tools/time_torch_ab_kernels.py [--tree DIR] [--json PATH] [--label NAME] [--ablate]

`--tree DIR` times the kernels of another checkout (its `gance_tpu_torch`,
built into its own build directory), so that two versions can be compared in
one run on one card. `--ablate` also builds measurement variants of A and B
(see VARIANTS) and times them. Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import ctypes
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="checkout whose gance_tpu_torch is timed (default: this one)")
    parser.add_argument("--json", type=Path, default=None, help="also write the records here")
    parser.add_argument("--label", default="", help="a name for this tree in the output")
    parser.add_argument("--ablate", action="store_true",
                        help="also build measurement variants of A and B (see VARIANTS)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.tree.resolve()))

    import chip_smoke as S
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops import precision
    from gance_tpu_torch.ops.cuda import build
    from gance_tpu_torch.ops.cuda import fused_ops as K

    label = args.label or str(args.tree)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; timing the kernels of {K.__file__}", flush=True)
    precision.apply_conv_precision()
    print(f"kernel build: {build.build_all():.1f} s", flush=True)
    for stem in ("fused_bias_noise_lrelu", "upsample2x_blur"):
        for line in (build.BUILD_DIR / f"{stem}.log").read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}")

    config = GeneratorConfig()
    gen = torch.Generator(device="cuda").manual_seed(S.SEED)
    shapes = S.path_shapes(config)
    cases = [("A", shape, n, 1) for shape, n in shapes["fused_bias_noise_lrelu"]]
    top = (S.TRAIN_BATCH, config.nf(config.resolution_log2 - 1), config.resolution,
           config.resolution)
    cases.append(("A", top, 0, S.TRAIN_BATCH))  # training's per-sample noise
    cases += [("B", shape, n, None) for shape, n in shapes["upsample2x_blur"]]

    records, totals = [], {}
    for kernel, shape, per_forward, noise_batch in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b, c, h, w = shape
            size = x.element_size()
            library = None
            if kernel == "A":
                noise = torch.randn((noise_batch, 1, h, w), generator=gen, device="cuda")
                bias = torch.randn((c,), generator=gen, device="cuda")
                strength = torch.tensor(0.37, device="cuda")
                run = lambda: K.fused_bias_noise_lrelu(x, noise, bias, strength)  # noqa: E731
                plain = lambda: K.fused_bias_noise_lrelu_plain(x, noise, bias, strength)  # noqa: E731
                moved = 2 * x.numel() * size + noise.numel() * 4
                what = f"A {shape} noise {tuple(noise.shape)}"
            else:
                run = lambda: K.upsample2x_blur(x, S.TAPS)  # noqa: E731
                plain = lambda: K.upsample2x_blur_plain(x, S.TAPS)  # noqa: E731
                kt = torch.tensor(np.outer(S.TAPS, S.TAPS)[::-1, ::-1].copy(), device="cuda")
                kt = kt.to(dtype).expand(c, 1, 4, 4)
                library = lambda: F.conv_transpose2d(x, kt, stride=2, padding=1, groups=c)  # noqa: E731
                moved = 5 * x.numel() * size
                what = f"B {shape}"
            with torch.no_grad():
                got, want = run(), plain()
                torch.cuda.synchronize()
                exact = bool(torch.equal(got, want))
                del got, want
                ms = S.time_ms(run)
                lib_ms = S.time_ms(library) if library is not None else None
            bound = moved / S.HBM_BYTES_PER_S * 1e3
            dname = str(dtype)[6:]
            print(f"{what} {dname}: ms {ms:.4f} bound {bound:.4f} share {bound / ms:.3f} "
                  f"GB/s {moved / ms / 1e6:.1f} library_ms "
                  f"{None if lib_ms is None else round(lib_ms, 4)} exact {exact}", flush=True)
            if not exact:
                print(f"MISMATCH against the twin: {what} {dname}", file=sys.stderr, flush=True)
            records.append({"kernel": kernel, "shape": list(shape), "noise_batch": noise_batch,
                            "dtype": dname, "per_forward": per_forward, "ms": ms,
                            "bound_ms": bound, "library_ms": lib_ms, "exact": exact})
            if per_forward:
                t = totals.setdefault((kernel, dname), {"ms": 0.0, "bound_ms": 0.0,
                                                        "library_ms": 0.0})
                t["ms"] += per_forward * ms
                t["bound_ms"] += per_forward * bound
                t["library_ms"] += per_forward * (lib_ms or 0.0)
            del x
    for (kernel, dname), t in sorted(totals.items()):
        print(f"sum {kernel} {dname} per synthesis forward at batch 8: ms {t['ms']:.4f} bound "
              f"{t['bound_ms']:.4f} share {t['bound_ms'] / t['ms']:.3f} library_ms "
              f"{t['library_ms'] if kernel == 'B' else None} [{label}] on {card}", flush=True)
    torch.cuda.empty_cache()
    host = host_phase(S, K, build, config, gen, card, label)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card, "tree": label, "records": records, "host_us": host,
            "totals": {f"{k} {d}": v for (k, d), v in totals.items()}}, indent=1))
    if args.ablate:
        ablate(S, K, build, config, gen, card)
    if not all(r["exact"] for r in records):
        sys.exit(1)


def host_phase(S, K, build, config, gen, card: str, label: str) -> dict:
    """Host microseconds per call of each wrapper at its smallest path shape
    (E at a small plane: its one path shape is bound by the device)."""
    from gance_tpu_torch.ops import upfirdn2d as U
    from gance_tpu_torch.ops.phase_block import fold_conv1_weights

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    shapes = S.path_shapes(config)
    a_shape = shapes["fused_bias_noise_lrelu"][0][0]
    b_shape = shapes["upsample2x_blur"][0][0]
    c_shape = shapes["blur4_separable_pad11"][0][0]
    d_shape = S.discriminator_shapes(config)[-1][0]
    e_shape = (S.BATCH, 256, 8, 8)
    x_a, noise, bias = randn(*a_shape), randn(1, 1, *a_shape[2:]), randn(a_shape[1])
    strength = torch.tensor(0.37, device="cuda")
    x_b, x_c, x_d = randn(*b_shape), randn(*c_shape), randn(*d_shape)
    b, c4, h, w = e_shape
    x_e = randn(*e_shape)
    w4 = fold_conv1_weights(randn(c4 // 4, c4 // 4, 3, 3) * 0.05)
    demod, nb = randn(b, c4).abs() + 0.5, randn(1, c4, h + 1, w + 1) * 0.1
    wrgb = randn(b, c4, 16) * 0.05
    # D's FIR as the resample plans hand it over: 16 row-major floats
    fir = tuple(float(v) for v in (np.outer(S.TAPS, S.TAPS) / 4.0).reshape(-1))
    wrappers = {  # name: (library, call, input plane)
        "A fused_bias_noise_lrelu": ("fused_bias_noise_lrelu",
                                     lambda: K.fused_bias_noise_lrelu(x_a, noise, bias, strength),
                                     x_a),
        "B upsample2x_blur": ("upsample2x_blur", lambda: K.upsample2x_blur(x_b, S.TAPS), x_b),
        "C blur4_separable_pad11": ("blur4_separable",
                                    lambda: K.blur4_separable_pad11(x_c, S.TAPS), x_c),
        "D stencil_blur4_valid": ("stencil_blur4_valid",
                                  lambda: K.stencil_blur4_valid(x_d, fir, (2, 2)), x_d),
        "E phase_conv1_torgb": ("phase_conv1_torgb",
                                lambda: K.phase_conv1_torgb(x_e, w4, demod, nb, wrgb), x_e),
    }
    results = {}
    for name, (library, call, x) in wrappers.items():
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
        results[name] = {"shape": list(x.shape), "inference_mode": served, "no_grad": no_grad,
                         "grad_enabled": grad, "bare_ctypes": bare, "depthwise_conv2d": conv}
        print(f"host us per call, {name} at {tuple(x.shape)}: wrapper inference_mode "
              f"{served:.2f}, no_grad {no_grad:.2f}, grad enabled {grad:.2f}; bare ctypes "
              f"{bare:.2f}; depthwise conv2d {conv:.2f} [{label}] on {card}", flush=True)
        del kept
    kernel = S.TAPS  # any 4-tap FIR: the analysis is the same
    if hasattr(U, "_plan"):  # the plan kept per (FIR, factor, gain)
        analysis = lambda: U._plan("up", kernel, (2, 1.0), U._upsample_plan)  # noqa: E731
    else:  # the per-call analysis of earlier trees

        def analysis():
            k = U.setup_filter_kernel(kernel, 4.0)
            return U._separable_4tap(k), U._separable_root(k)

    with torch.inference_mode():
        caller = host_us(lambda: U.upsample_2d(x_b))
    tap = host_us(analysis)
    results["upsample_2d"] = {"inference_mode": caller, "tap_analysis": tap}
    print(f"host us per call, upsample_2d at {tuple(x_b.shape)}: {caller:.2f} under "
          f"inference_mode; its tap analysis alone {tap:.2f} [{label}] on {card}", flush=True)
    return results


# (kernel stem, variant) -> nvcc flags beside the port's (the sources' measurement macros)
VARIANTS = {
    "fused_bias_noise_lrelu": {
        "as built": [],
        "no noise read": ["-DGANCE_A_ABLATE=1"],
        "no arithmetic": ["-DGANCE_A_ABLATE=2"],
        "scalar path only": ["-DGANCE_A_ABLATE=3"],
        "one channel per thread": ["-DGANCE_A_CHANNELS_PER_THREAD=1"],
        "one load in flight": ["-DGANCE_A_IN_FLIGHT=1"],
    },
    "upsample2x_blur": {
        "as built": [],
        "empty kernel": ["-DGANCE_B_ABLATE=1"],
        "scalar path only": ["-DGANCE_B_ABLATE=2"],
        "16-byte units (two stores a row)": ["-DGANCE_B_UNIT_BYTES=16"],
        "8 rows a thread": ["-DGANCE_B_ROWS=8"],
    },
}


def ablate(S, K, build, config, gen, card) -> None:
    """A at its largest path shape, (8, 64, 1024, 1024), and B at its largest
    and smallest, built as VARIANTS and called through their C entry points on
    the same inputs: which part of the kernel holds its time. Only "as built"
    is checked against the twin; the others compute something else by design.
    The empty B also gives its host microseconds per bare call: launch and
    ctypes alone."""
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, variants in VARIANTS.items():
        for i, (name, extra) in enumerate(variants.items()):
            lib = out_dir / f"{stem}-{i}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(lib),
                   str(build.CSRC / f"{stem}.cu")]
            jobs[(stem, name)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT))
    fns = {}
    for (stem, name), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {stem} {name}: nvcc failed\n{log.decode(errors='replace')}")
        regs = [line.strip() for line in log.decode(errors="replace").splitlines()
                if "registers" in line]
        print(f"ptxas {stem} {name}: {regs}", flush=True)
        symbol, argtypes = build.FUNCTIONS[stem]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(stem, name)] = fn
    shapes = S.path_shapes(config)
    a_top = shapes["fused_bias_noise_lrelu"][-1][0]
    b_small, b_top = shapes["upsample2x_blur"][0][0], shapes["upsample2x_blur"][-1][0]
    strength = torch.tensor(0.37, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        code = K._DTYPE_CODES[dtype]
        cases = []
        b, c, h, w = a_top
        x = torch.randn(a_top, generator=gen, device="cuda").to(dtype)
        noise = torch.randn((1, 1, h, w), generator=gen, device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        out = torch.empty_like(x)
        cases.append(("fused_bias_noise_lrelu", a_top, out,
                      lambda x=x, noise=noise, bias=bias: K.fused_bias_noise_lrelu_plain(
                          x, noise, bias, strength),
                      (x.data_ptr(), noise.data_ptr(), bias.data_ptr(), strength.data_ptr(),
                       out.data_ptr(), b * c, c, h * w, 0, code),
                      (2 * x.numel() * x.element_size() + noise.numel() * 4), (x, noise, bias)))
        for shape in (b_top, b_small):
            b, c, h, w = shape
            xb = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            ob = torch.empty((b, c, 2 * h, 2 * w), dtype=dtype, device="cuda")
            cases.append(("upsample2x_blur", shape, ob,
                          lambda xb=xb: K.upsample2x_blur_plain(xb, S.TAPS),
                          (xb.data_ptr(), ob.data_ptr(), b * c, h, w, *S.TAPS, code),
                          5 * xb.numel() * xb.element_size(), (xb,)))
        for stem, shape, out, plain, args, moved, _keep in cases:
            bound = moved / S.HBM_BYTES_PER_S * 1e3
            stream = torch.cuda.current_stream().cuda_stream
            for name in VARIANTS[stem]:
                fn = fns[(stem, name)]

                def call(fn=fn, args=args):
                    rc = fn(*args, stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                if name == "as built" and not torch.equal(out, plain()):
                    raise RuntimeError(f"{stem} {shape} as built differs from its twin")
                ms = S.time_ms(call)
                extra = f" host us per bare call {host_us(call):.2f}" if name == "empty kernel" else ""
                print(f"ablate {stem} {tuple(shape)} {str(dtype)[6:]} {name}: ms {ms:.4f} "
                      f"bound {bound:.4f} share {bound / ms:.3f}{extra} on {card}", flush=True)
        del cases, x, noise, bias, out


if __name__ == "__main__":
    main()
