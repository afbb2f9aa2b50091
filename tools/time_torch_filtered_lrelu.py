#!/usr/bin/env python3
"""
Kernel F (`ops/filtered_lrelu.py`, StyleGAN3's filtered leaky ReLU) alone on
the GPU at every layer shape of the 1024px StyleGAN3-T network at batch 8,
against its plain twin (the port's separable `upfirdn2d` and `bias_act`,
cuDNN's depthwise convolutions in fp32):

  * per layer: F's ms by CUDA events (the median of rounds of launches), its
    bound (port_bench/reference/bounds_sg3.py: bytes at 3.35 TB/s or
    operations at 67 TFLOP/s fp32) and the bound's share of F's time, the
    twin's ms, and F's largest difference from the twin;
  * per synthesis forward (the 14 layers): the sums, and the card's name and
    power limit.

    python3 tools/time_torch_filtered_lrelu.py [--json PATH]

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gance_tpu_torch.models import stylegan3 as S  # noqa: E402
from gance_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain  # noqa: E402
from gance_tpu_torch.ops.precision import exact_fp32  # noqa: E402
from port_bench.reference import bounds_sg3  # noqa: E402

BATCH, ROUNDS, LAUNCHES = 8, 5, 10


def ms_per_call(fn, launches: int = LAUNCHES, rounds: int = ROUNDS) -> float:
    """Median over rounds of the device ms per call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--json", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    bench_config = json.loads((ROOT / "port_bench/configs/stylegan3-t-1024.json").read_text())
    bounds = dict(zip([s["name"] for s in bounds_sg3.f_layers(bench_config)],
                      [b for _, b in bounds_sg3.forward_launches(bench_config, BATCH)]))
    rows, total = [], {"f_ms": 0.0, "twin_ms": 0.0, "bound_ms": 0.0}
    gen = torch.Generator(device=device).manual_seed(0)
    for geo in S.synthesis_geometry(S.StyleGAN3Config())[1]:
        if geo.is_torgb:
            continue
        side = geo.in_size + geo.kernel - 1
        x = torch.randn((BATCH, geo.out_channels, side, side), generator=gen, device=device) * 2
        bias = torch.randn((geo.out_channels,), generator=gen, device=device) * 0.2
        scale = torch.rand((BATCH, geo.out_channels), generator=gen, device=device) + 0.5
        call = (geo.up_filter, geo.down_filter, bias, geo.up, geo.down, geo.padding, geo.gain,
                geo.slope, geo.clamp)
        with torch.inference_mode(), exact_fp32():
            got = filtered_lrelu(x, *call, scale=scale)
            # the twin two rows at a time: its upsampled grid at batch 8 is
            # tens of GB at the widest layers
            want = torch.cat([filtered_lrelu_plain(x[i:i + 2], *call, scale[i:i + 2])
                              for i in range(0, BATCH, 2)])
            err = float((got - want).abs().max())
            del got, want
            f_ms = ms_per_call(lambda: filtered_lrelu(x, *call, scale=scale))
            twin_ms = ms_per_call(lambda: [filtered_lrelu_plain(x[i:i + 2], *call, scale[i:i + 2])
                                           for i in range(0, BATCH, 2)], launches=2, rounds=3)
        bound_ms = bounds[geo.name] * 1e3
        row = {"layer": geo.name, "f_ms": f_ms, "bound_ms": bound_ms,
               "roofline_pct": 100 * bound_ms / f_ms, "twin_ms": twin_ms, "max_abs_err": err}
        print(json.dumps(row), flush=True)
        rows.append(row)
        for key in total:
            total[key] += row[key]
        del x
        torch.cuda.empty_cache()
    total.update(roofline_pct=100 * total["bound_ms"] / total["f_ms"], card=card(),
                 batch=BATCH)
    print(json.dumps({"per_forward": total}), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"layers": rows, "per_forward": total}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
