#!/usr/bin/env python3
"""
The `Conv0_up` transposed conv of config-f 1024px synthesis at batch 8, at
each of its eight shapes, in four forms on the GPU, fp32 (TF32 off, as
GANCE_TPU_PRECISION=highest runs it) and bf16:

  transposed  `F.conv_transpose2d` (cuDNN's backward-data pass), the form the
              port ran before the phases;
  phases      `ops/upfirdn2d.py::transposed_conv_phases`: four stride-1 convs
              (2x2, 2x1, 1x2, 1x1 taps), each written into its strided slice
              of one `torch.empty` (the port's form where the blur after it
              is not kernel C);
  stacked     the same four convs, the three smaller phases padded to
              (H+1) x (W+1), stacked, reshaped and cropped;
  shuffled    one 2x2 conv to 4 * Cout phase channels (16 taps against 9, the
              missing ones zero), `pixel_shuffle`, cropped.

Each form is timed by CUDA events under cuDNN's default algorithms and under
`deterministic_cudnn`, the forms in the order transposed, phases, stacked,
shuffled and back, and called three times per mode to see whether it repeats
bit for bit. Prints per shape and summed over one forward, and each form's
max abs difference from the phases relative to max |phases|.

Then the layer with its blur (kernel C), fp32 at batch 8 under the default
algorithms, in three routes, in the order transposed + C, interleaved + C,
port and back:

  transposed + C    `F.conv_transpose2d`, then C on its output;
  interleaved + C   `transposed_conv_phases` (the phases written into one
                    tensor), then C on it;
  port              `ops/upfirdn2d.py::upsample_conv_2d`: the phases, then
                    C's phase-plane form reading them where they lie; it
                    must equal interleaved + C bit for bit.

Then forward and backward (the gradients of x and w) at training's batch 4
in fp32, under the default algorithms, in the order transposed, phases,
port and back: `transposed` and `phases` through autograd (the phases' own
backward: four backward-data passes and four weight gradients), `port`
through `ops/upfirdn2d.py::_PhasedTransposedConv` (the phases forward, the
transposed conv's `convolution_backward`).

    python3 tools/time_torch_upconv_phases.py [--json PATH] [--blur-only]

`--blur-only` times the layer with its blur and nothing else.

Prints the card's name and power limit first. Needs a CUDA GPU; exits 1
without one.
"""

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
BATCH = 8
TRAIN_BATCH = 4  # NVlabs config-f's per-GPU minibatch
FORMS = ("transposed", "phases", "stacked", "shuffled")


def transposed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), stride=2)


def stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, _, h, wd = x.shape
    p00 = F.conv2d(x, w[:, :, 0::2, 0::2], padding=1)
    p01 = F.conv2d(x, w[:, :, 0::2, 1:2], padding=(1, 0))
    p10 = F.conv2d(x, w[:, :, 1:2, 0::2], padding=(0, 1))
    p11 = F.conv2d(x, w[:, :, 1:2, 1:2])
    row0 = torch.stack([p00, F.pad(p01, (0, 1))], dim=-1)
    row1 = torch.stack([F.pad(p10, (0, 0, 0, 1)), F.pad(p11, (0, 1, 0, 1))], dim=-1)
    y = torch.stack([row0, row1], dim=3)  # (B, C, H+1, row phase, W+1, column phase)
    return y.reshape(b, -1, 2 * h + 2, 2 * wd + 2)[:, :, :2 * h + 1, :2 * wd + 1].contiguous()


def shuffled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, _, h, wd = x.shape
    cout, cin = w.shape[:2]
    # per axis, phase 0 takes taps (0, 2) at window offsets (0, 1), phase 1 tap 1 at offset 1
    w4 = w.new_zeros((cout, 2, 2, cin, 2, 2))
    w4[:, 0, 0] = w[:, :, 0::2, 0::2]
    w4[:, 0, 1, :, :, 1] = w[:, :, 0::2, 1]
    w4[:, 1, 0, :, 1, :] = w[:, :, 1, 0::2]
    w4[:, 1, 1, :, 1, 1] = w[:, :, 1, 1]
    y = F.pixel_shuffle(F.conv2d(x, w4.reshape(4 * cout, cin, 2, 2), padding=1), 2)
    return y[:, :, :2 * h + 1, :2 * wd + 1].contiguous()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", type=Path, help="also write the rows here")
    parser.add_argument("--blur-only", action="store_true",
                        help="time only the layer with its blur")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("a CUDA GPU is needed", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops import precision
    from gance_tpu_torch.ops.cuda import fused_ops as K
    from gance_tpu_torch.ops.upfirdn2d import (
        DEFAULT_RESAMPLE_KERNEL,
        _PhasedTransposedConv,
        _plan,
        _upsample_conv_plan,
        transposed_conv_phases,
        upsample_conv_2d,
    )

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    precision.apply_conv_precision()
    config = GeneratorConfig()
    forms: Dict[str, Callable] = {"transposed": transposed,
                                  "phases": lambda x, w: transposed_conv_phases(x, w, 2),
                                  "stacked": stacked, "shuffled": shuffled}
    modes = {"default": contextlib.nullcontext, "deterministic": precision.deterministic_cudnn}
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows: List[dict] = []
    taps = _plan("up_conv", DEFAULT_RESAMPLE_KERNEL, (2, 1.0, 3), _upsample_conv_plan)[1]
    routes: Dict[str, Callable] = {
        "transposed + C": lambda x, w: K.blur4_separable_pad11(transposed(x, w), taps),
        "interleaved + C": lambda x, w: K.blur4_separable_pad11(
            transposed_conv_phases(x, w, 2), taps),
        "port": upsample_conv_2d}
    route_sums = {route: 0.0 for route in routes}
    for res in range(3, config.resolution_log2 + 1):
        cin, cout, side = config.nf(res - 2), config.nf(res - 1), 2 ** (res - 1)
        x = torch.randn((BATCH, cin, side, side), generator=gen, device="cuda")
        w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / (9 * cin) ** 0.5
        row = {"dtype": "float32", "blur": True, "x": [BATCH, cin, side, side], "cout": cout}
        times = {route: [] for route in routes}
        with torch.inference_mode():
            for route in tuple(routes) + tuple(routes)[::-1]:
                times[route].append(time_ms(lambda: routes[route](x, w), 100.0))
            port, interleaved = routes["port"](x, w), routes["interleaved + C"](x, w)
            if not torch.equal(port, interleaved):
                print(f"port differs from interleaved + C at {row['x']}", file=sys.stderr)
                sys.exit(1)
        for route in routes:
            ms = sum(times[route]) / len(times[route])
            row[f"{route} ms"] = round(ms, 4)
            route_sums[route] += ms
        del x, w, port, interleaved
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(f"float32 Conv0_up with its blur per forward at batch {BATCH}, default cuDNN, ms: "
          + ", ".join(f"{route} {route_sums[route]:.3f}" for route in routes), flush=True)
    if args.blur_only:
        if args.json:
            args.json.write_text(json.dumps(rows, indent=1))
        return
    for dtype in (torch.float32, torch.bfloat16):
        sums = {(form, mode): 0.0 for form in FORMS for mode in modes}
        for res in range(3, config.resolution_log2 + 1):
            cin, cout, side = config.nf(res - 2), config.nf(res - 1), 2 ** (res - 1)
            x = torch.randn((BATCH, cin, side, side), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
                 / (9 * cin) ** 0.5).to(dtype)
            row = {"dtype": str(dtype)[6:], "x": [BATCH, cin, side, side], "cout": cout}
            with torch.inference_mode():
                ref = forms["phases"](x, w).float()
                for mode, context in modes.items():
                    times: Dict[str, List[float]] = {form: [] for form in FORMS}
                    with context():
                        for form in FORMS + FORMS[::-1]:
                            times[form].append(time_ms(lambda: forms[form](x, w), 100.0))
                        for form in FORMS:
                            outs = [forms[form](x, w) for _ in range(3)]
                            row[f"{form} repeats {mode}"] = all(
                                torch.equal(outs[0], o) for o in outs[1:])
                            if mode == "default":
                                row[f"{form} max_rel"] = float(
                                    (outs[0].float() - ref).abs().max() / ref.abs().max())
                            del outs
                    for form in FORMS:
                        ms = sum(times[form]) / len(times[form])
                        row[f"{form} ms {mode}"] = round(ms, 4)
                        sums[form, mode] += ms
            del x, w, ref
            torch.cuda.empty_cache()
            rows.append(row)
            print(json.dumps(row), flush=True)
        for mode in modes:
            print(f"{str(dtype)[6:]} Conv0_up transposed convs per forward at batch {BATCH}, "
                  f"{mode} cuDNN, ms: " + ", ".join(
                      f"{form} {sums[form, mode]:.3f}" for form in FORMS), flush=True)
    grad_forms: Dict[str, Callable] = {
        "transposed": transposed, "phases": forms["phases"],
        "port": lambda x, w: _PhasedTransposedConv.apply(x, w, 2)}
    grad_sums = {form: 0.0 for form in grad_forms}
    for res in range(3, config.resolution_log2 + 1):
        cin, cout, side = config.nf(res - 2), config.nf(res - 1), 2 ** (res - 1)
        x = torch.randn((TRAIN_BATCH, cin, side, side), generator=gen,
                        device="cuda").requires_grad_(True)
        w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
             / (9 * cin) ** 0.5).requires_grad_(True)
        g = torch.randn((TRAIN_BATCH, cout, 2 * side + 1, 2 * side + 1), generator=gen,
                        device="cuda")
        row = {"dtype": "float32", "backward": True, "x": list(x.shape), "cout": cout}
        times = {form: [] for form in grad_forms}
        for form in tuple(grad_forms) + tuple(grad_forms)[::-1]:
            times[form].append(time_ms(
                lambda: torch.autograd.grad((grad_forms[form](x, w) * g).sum(), (x, w)), 100.0))
        for form in grad_forms:
            ms = sum(times[form]) / len(times[form])
            row[f"{form} ms forward and backward"] = round(ms, 4)
            grad_sums[form] += ms
        del x, w, g
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(f"float32 Conv0_up transposed convs, forward and backward per forward at batch "
          f"{TRAIN_BATCH}, default cuDNN, ms: " + ", ".join(
              f"{form} {grad_sums[form]:.3f}" for form in grad_forms), flush=True)
    if args.json:
        args.json.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
