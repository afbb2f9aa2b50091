#!/usr/bin/env python3
"""
Kernels C (`blur4_separable_pad11`) and D (`stencil_blur4_valid`) alone on
the GPU, at every shape the 1024px config-f path gives them, in fp32 and
bf16:

  * C at batch 8: its input after each `Conv0_up` transpose conv of one
    synthesis forward, (8, C, 2r+1, 2r+1) for r = 4 .. 512;
  * D at batch 4: every blur of one discriminator forward (pads (2, 2)
    before each 3x3 `Conv1_down`, (1, 1) before each 1x1 `Skip`), and C's
    input gradient at the top block, (4, 64, 1024, 1024) padded (2, 2).

For each shape it checks the kernel against its plain twin (bit for bit,
atol 0) and prints the kernel's ms by CUDA events, the bound (each input
byte read once and each output byte written once at 3.35 TB/s, as
`chip_smoke.py` phase 2 counts it), the bound's share of the kernel time,
the achieved GB/s, and the depthwise `conv2d` that computes the same
function (the yardstick, not used by the port). Then the sums per synthesis
forward (C) and per discriminator forward (D).

    python3 tools/time_torch_stencil_kernels.py [--kernels C,D] [--tree DIR] [--json PATH] [--ablate]

`--tree DIR` times the kernels of another checkout (its `gance_tpu_torch`,
built into its own build directory), so that two versions can be compared
in one run on one card. Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", default="C,D", help="comma-separated subset of C,D")
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="checkout whose gance_tpu_torch is timed (default: this one)")
    parser.add_argument("--json", type=Path, default=None, help="also write the records here")
    parser.add_argument("--label", default="", help="a name for this tree in the output")
    parser.add_argument("--ablate", action="store_true",
                        help="also build measurement variants of C and D (see ablate()) and time "
                             "them at their largest path shape")
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
    for stem in ("blur4_separable", "stencil_blur4_valid"):
        for line in (build.BUILD_DIR / f"{stem}.log").read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}")

    config = GeneratorConfig()
    gen = torch.Generator(device="cuda").manual_seed(S.SEED)
    kernels = set(args.kernels.upper().split(","))
    cases = []  # (kernel, shape, per forward, option, FIR, note)
    if "C" in kernels:
        for shape, n in S.path_shapes(config)["blur4_separable_pad11"]:
            cases.append(("C", shape, n, None, None, ""))
    if "D" in kernels:
        binomial = np.outer(S.TAPS, S.TAPS) / 4.0
        for shape, n, pads in S.discriminator_shapes(config):
            cases.append(("D", shape, n, pads, binomial, ""))
        top = (S.TRAIN_BATCH, config.nf(config.resolution_log2 - 1), config.resolution,
               config.resolution)
        cases.append(("D", top, 0, (2, 2), np.outer(S.TAPS, S.TAPS)[::-1, ::-1],
                      " (C's input gradient)"))

    records = []
    totals = {}
    for kernel, shape, per_forward, pads, fir, note in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b, c, h, w = shape
            size = x.element_size()
            if kernel == "C":
                run = lambda: K.blur4_separable_pad11(x, S.TAPS)  # noqa: E731
                plain = lambda: K.blur4_separable_pad11_plain(x, S.TAPS)  # noqa: E731
                kt = torch.tensor(np.outer(S.TAPS, S.TAPS), dtype=dtype, device="cuda")
                kt = kt.expand(c, 1, 4, 4)
                library = lambda: F.conv2d(x, kt, padding=1, groups=c)  # noqa: E731
                outs = b * c * (h - 1) * (w - 1)
                what = f"C {shape}"
            else:
                p0, p1 = pads
                run = lambda: K.stencil_blur4_valid(x, fir, pads)  # noqa: E731
                plain = lambda: K.stencil_blur4_valid_plain(x, fir, pads)  # noqa: E731
                kt = torch.tensor(np.ascontiguousarray(fir), dtype=dtype, device="cuda")
                kt = kt.expand(c, 1, 4, 4)
                library = lambda: F.conv2d(x, kt, padding=p0, groups=c)  # noqa: E731
                outs = b * c * (h + p0 + p1 - 3) * (w + p0 + p1 - 3)
                what = f"D {shape} pads {pads}{note}"
            moved = (x.numel() + outs) * size
            with torch.no_grad():
                got, want = run(), plain()
                torch.cuda.synchronize()
                exact = bool(torch.equal(got, want))
                del got, want
                ms, lib_ms = S.time_ms(run), S.time_ms(library)
            bound = moved / S.HBM_BYTES_PER_S * 1e3
            dname = str(dtype)[6:]
            print(f"{what} {dname}: ms {ms:.4f} bound {bound:.4f} share {bound / ms:.3f} "
                  f"GB/s {moved / ms / 1e6:.1f} library_ms {lib_ms:.4f} exact {exact}", flush=True)
            if not exact:
                print(f"MISMATCH against the twin: {what} {dname}", file=sys.stderr, flush=True)
            records.append({"kernel": kernel, "shape": list(shape), "pads": pads, "note": note,
                            "dtype": dname, "per_forward": per_forward, "ms": ms,
                            "bound_ms": bound, "library_ms": lib_ms, "exact": exact})
            if per_forward:
                t = totals.setdefault((kernel, dname), {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0})
                t["ms"] += per_forward * ms
                t["bound_ms"] += per_forward * bound
                t["library_ms"] += per_forward * lib_ms
            del x
    for (kernel, dname), t in sorted(totals.items()):
        unit = "synthesis forward at batch 8" if kernel == "C" else "discriminator forward at batch 4"
        print(f"sum {kernel} {dname} per {unit}: ms {t['ms']:.4f} bound {t['bound_ms']:.4f} "
              f"share {t['bound_ms'] / t['ms']:.3f} library_ms {t['library_ms']:.4f} [{label}] "
              f"on {card}", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "tree": label, "records": records,
                                         "totals": {f"{k} {d}": v for (k, d), v in totals.items()}},
                                        indent=1))
    if args.ablate:
        ablate(S, K, build, config, gen, card)
    if not all(r["exact"] for r in records):
        sys.exit(1)


# variant -> nvcc flags beside the port's (csrc/stencil4.cuh's measurement macros)
VARIANTS = {
    "as built": [],
    "fused multiply-add (not bit-exact)": ["--fmad=true"],
    "no arithmetic": ["-DGANCE_STENCIL4_ABLATE=1"],
    "no stores": ["-DGANCE_STENCIL4_ABLATE=2"],
    "no second column part": ["-DGANCE_STENCIL4_ABLATE=3"],
    "8 stages": ["-DGANCE_STENCIL4_STAGES=8"],
    "units of at most 128 threads": ["-DGANCE_STENCIL4_MAX_UNIT=128"],
    "at most 64 registers": ["-DGANCE_STENCIL4_MIN_BLOCKS=2"],
}


def ablate(S, K, build, config, gen, card) -> None:
    """C and D at their largest path shape, (8, 64, 1025, 1025) and (4, 64,
    1024, 1024) padded (2, 2), built as VARIANTS and called through their C
    entry points on the same inputs: which part of the kernel holds its
    time. Only "as built" is checked against the twin; the others compute
    something else by design."""
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in ("blur4_separable", "stencil_blur4_valid"):
        for i, (name, extra) in enumerate(VARIANTS.items()):
            flags = [f for f in build.NVCC_FLAGS if not (extra and f == "--fmad=false" and
                                                         "--fmad=true" in extra)]
            lib = out_dir / f"{stem}-{i}.so"
            cmd = [build._nvcc(), *flags, *extra, "-o", str(lib), str(build.CSRC / f"{stem}.cu")]
            jobs[(stem, name)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT))
    fns = {}
    for (stem, name), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {stem} {name}: nvcc failed\n{log.decode(errors='replace')}")
        symbol, argtypes = build.FUNCTIONS[stem]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(stem, name)] = fn
    top_d = (S.TRAIN_BATCH, config.nf(config.resolution_log2 - 1), config.resolution,
             config.resolution)
    top_c = S.path_shapes(config)["blur4_separable_pad11"][-1][0]
    fir = np.outer(S.TAPS, S.TAPS)[::-1, ::-1]
    taps16 = (ctypes.c_float * 16)(*np.asarray(fir, np.float32).reshape(-1))
    for dtype in (torch.float32, torch.bfloat16):
        code = K._DTYPE_CODES[dtype]
        for stem, shape in (("blur4_separable", top_c), ("stencil_blur4_valid", top_d)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b, c, h, w = shape
            if stem == "blur4_separable":
                out = torch.empty((b, c, h - 1, w - 1), dtype=dtype, device="cuda")
                want = K.blur4_separable_pad11_plain(x, S.TAPS)
                args = (x.data_ptr(), out.data_ptr(), b * c, h, w, w, *S.TAPS, code)
            else:
                out = torch.empty((b, c, h + 1, w + 1), dtype=dtype, device="cuda")
                want = K.stencil_blur4_valid_plain(x, fir, (2, 2))
                args = (x.data_ptr(), out.data_ptr(), b * c, h, w, 2, 2, taps16, code)
            bound = (x.numel() + out.numel()) * x.element_size() / S.HBM_BYTES_PER_S * 1e3

            def call(fn=None):
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            for name in VARIANTS:
                fn = fns[(stem, name)]
                call(fn)
                torch.cuda.synchronize()
                if name == "as built" and not torch.equal(out, want):
                    raise RuntimeError(f"{stem} as built differs from its twin")
                ms = S.time_ms(lambda: call(fn))
                print(f"ablate {stem} {tuple(shape)} {str(dtype)[6:]} {name}: ms {ms:.4f} "
                      f"bound {bound:.4f} share {bound / ms:.3f} on {card}", flush=True)
            del x, out, want


if __name__ == "__main__":
    main()
