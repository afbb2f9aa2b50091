#!/usr/bin/env python3
"""
Kernel E (`phase_conv1_torgb`) alone on the GPU: the kernel through its
wrapper, its dense twin and the composition it replaces (cuDNN conv +
epilogue + einsum), at the 1024px top block's shape by default, fp32 and
bf16, with the same inputs and checks as `chip_smoke.py` phase 2 (w4 the
fold of a random 3x3 weight; fp32 within 1e-4 and bf16 within 1e-2 of the
output's scale). Also times the wrapper's preparation alone (the nine taps,
the fold check and their layout for the kernel), which the kernel time
includes, and, for reference, x's conversion to channels-last by PyTorch
beside a plain copy of x (the kernel reads NCHW x and needs neither).

    python3 tools/time_torch_phase_kernel.py [--batch 8] [--c4 256] [--size 512]

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--c4", type=int, default=256)
    parser.add_argument("--size", type=int, default=512, help="H = W of the phase planes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)

    import chip_smoke as S
    from gance_tpu_torch.ops import precision
    from gance_tpu_torch.ops.cuda import build
    from gance_tpu_torch.ops.cuda import fused_ops as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    precision.apply_conv_precision()
    print(f"kernel build: {build.build_all():.1f} s", flush=True)
    for line in (build.BUILD_DIR / "phase_conv1_torgb.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    b, c4, h = args.batch, args.c4, args.size
    c = c4 // 4
    gen = torch.Generator(device="cuda").manual_seed(S.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for dtype in (torch.float32, torch.bfloat16):
        x = (randn(b, c4, h, h) * 0.5).to(dtype)
        w4 = K.fold_conv1_weights(randn(c, c, 3, 3) * (9 * c) ** -0.5)
        demod = randn(b, c4).abs() + 0.5
        nb = randn(1, c4, h + 1, h + 1) * 0.1
        wrgb = randn(b, c4, 16) * c4 ** -0.5
        wrgb[:, :, 12:] = 0.0
        w4d, demodd, nbd, wrgbd = (t.to(dtype) for t in (w4, demod, nb, wrgb))

        def library() -> torch.Tensor:
            z = F.conv2d(x, w4d, padding=1) * demodd[:, :, None, None] + nbd
            z = torch.maximum(z, z * 0.2)
            return torch.einsum("bchw,bck->bkhw", z, wrgbd)

        def prepare() -> torch.Tensor:
            v = K.unfold_conv1_weights(w4)
            torch._assert_async((K.fold_conv1_weights(v) == w4).all())
            return v.to(dtype).permute(1, 2, 3, 0).reshape(c, 9, c).contiguous()

        got = K.phase_conv1_torgb(x, w4, demod, nb, wrgb)
        want = K.phase_conv1_torgb_plain(x, w4, demod, nb, wrgb)
        torch.cuda.synchronize()
        err = S.check_close(f"E {str(dtype)[6:]}", got, want, fp32_rel=1e-4, bf16_rel=1e-2)
        lib_err = S.check_close("composition", library(), want, fp32_rel=1e-4, bf16_rel=5e-2) \
            if dtype == torch.float32 else float("nan")
        del got, want
        ms = S.time_ms(lambda: K.phase_conv1_torgb(x, w4, demod, nb, wrgb))
        lib_ms = S.time_ms(library)
        prep_ms = S.time_ms(prepare)
        # what a kernel that took channels-last x would add (E reads NCHW x)
        cl_ms = S.time_ms(lambda: x.contiguous(memory_format=torch.channels_last))
        copy_ms = S.time_ms(lambda: x.clone())
        ms2 = S.time_ms(lambda: K.phase_conv1_torgb(x, w4, demod, nb, wrgb))
        flops = 2 * (h + 1) ** 2 * (b * int(torch.count_nonzero(w4)) + int(torch.count_nonzero(wrgb)))
        rate = S.BF16_FLOPS_PER_S if dtype == torch.bfloat16 else S.FP32_FLOPS_PER_S
        print(f"E ({b}, {c4}, {h}, {h}) {str(dtype)[6:]}: ms {ms:.4f} then {ms2:.4f}, composition "
              f"{lib_ms:.4f}, wrapper preparation {prep_ms:.4f}, bound {flops / rate * 1e3:.4f} "
              f"(operations), max_abs_err {err:.3g} (composition {lib_err:.3g}); x to "
              f"channels-last {cl_ms:.4f}, a plain copy of x {copy_ms:.4f}; on {card}", flush=True)
        del x


if __name__ == "__main__":
    main()
