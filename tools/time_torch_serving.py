#!/usr/bin/env python3
"""
Sustained serving of the port's daemon under concurrent clients (the
counterpart of tools/bench_serving_daemon.py): `--clients` threads post
/synthesize requests of `--request-frames` seeded z rows back to back to a
`gance_tpu_torch.serving.SynthesisDaemon` over one network with seeded random
weights, through HTTP, the batcher, the device and the npy egress.

    python3 tools/time_torch_serving.py [--dtype bfloat16] [--phase on] [--trace]
    python3 tools/time_torch_serving.py --device cpu --resolution 16 --fmap-base 256 \\
        --fmap-max 32 --seconds 1     # a CPU smoke run

It prints one JSON line: frames/s and requests/s over the timed window
(every request that completed inside it), the clients' p50/p99 latency of the
requests that started and completed inside it (HTTP round trip and npy decode
included), the daemon's batches, mean batch and
occupancy over the window, its own p50/p99, and with `--trace` the device's
idle share over the window (torch.profiler, device events only). The load
generator is `chip_smoke.py`'s `serving_load`, so phase 12d and this tool
measure alike. Every bucket is warmed first (both lanes).
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--resolution", type=int, default=1024)
    parser.add_argument("--fmap-base", type=int, default=None)
    parser.add_argument("--fmap-max", type=int, default=None)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--phase", default="off", choices=["off", "on"],
                        help="GANCE_TPU_PHASE1024 (the polyphase top block, kernel E)")
    parser.add_argument("--clients", type=int, default=6)
    parser.add_argument("--request-frames", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--settle-seconds", type=float, default=2.0)
    parser.add_argument("--max-batch", type=int, default=48)
    parser.add_argument("--max-delay-ms", type=float, default=5.0)
    parser.add_argument("--trace", action="store_true",
                        help="the device's idle share over the window (CUDA only)")
    args = parser.parse_args()

    import torch

    from chip_smoke import SEED, serving_load, set_phase, smoke_params
    from gance_tpu_torch.cli.serve import warm_networks
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.serving import SynthesisDaemon
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork
    from gance_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    card = None
    if device.type == "cuda":
        from gance_tpu_torch.ops.cuda import build

        build.build_all()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    widths = {k: v for k, v in (("fmap_base", args.fmap_base), ("fmap_max", args.fmap_max))
              if v is not None}
    config = GeneratorConfig(resolution=args.resolution, **widths)
    network = SynthesisNetwork(params=smoke_params(SEED, config), config=config, device=device,
                               compute_dtype=getattr(torch, args.dtype))
    set_phase(args.phase)
    warm_networks([network], args.max_batch, "all")
    with SynthesisDaemon([network], port=0, max_batch=args.max_batch,
                         max_delay_ms=args.max_delay_ms) as daemon, \
            tempfile.TemporaryDirectory(prefix=".time_torch_serving_", dir=ROOT) as tmp:
        r = serving_load(f"http://127.0.0.1:{daemon.port}", args.clients, args.request_frames,
                         args.seconds, args.settle_seconds,
                         Path(tmp) if args.trace and device.type == "cuda" else None)
        daemon.drain(timeout_s=120)
    print(json.dumps({
        "metric": f"{args.resolution}px serving sustained frames/sec ({args.clients} clients x "
                  f"{args.request_frames} frames/request, {args.dtype}, phase path {args.phase})",
        "value": r["frames_per_s"], "unit": "frames/sec", **{k: v for k, v in r.items()
                                                             if k != "frames_per_s"},
        "max_batch": args.max_batch, "linger_ms": args.max_delay_ms, "device": str(device),
        "card": card,
    }))


if __name__ == "__main__":
    main()
