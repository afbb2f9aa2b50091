#!/usr/bin/env python3
"""
What cuDNN's deterministic algorithms cost the port's synthesis on the GPU,
and whether a batch repeats itself bit for bit with and without them.

Config-f 1024px with `chip_smoke.py`'s seeded random weights, batch 8 of
seeded z, fp32 and bf16, the phase path off and on. For each case it times
`SynthesisNetwork.device_images_from_vectors` by CUDA events with
`torch.backends.cudnn.deterministic` off (cuDNN's default algorithms) and on
(`gance_tpu_torch.ops.precision.deterministic_cudnn`, which the resumable
renders run under), in the order off, on, on, off, and renders the batch
three times under each to see whether the frames repeat. Each fp32 `Conv0_up`
runs as stride-1 phase convolutions (`ops/upfirdn2d.py::phase_convs`, which
kernel C then reads), forward passes whose cuDNN algorithms add no atomics; a transposed
convolution's forward, cuDNN's backward-data pass, may add with atomics in
fp32 (run this script from an older checkout to see it).

    python3 tools/time_torch_deterministic_cudnn.py

Prints the card's name and power limit first. Needs a CUDA GPU; exits 1
without one.
"""

import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    if not torch.cuda.is_available():
        print("a CUDA GPU is needed", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops import precision
    from gance_tpu_torch.ops.cuda import build
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    precision.apply_conv_precision()
    build.build_all()
    config = GeneratorConfig()
    params = chip_smoke.smoke_params(chip_smoke.SEED, config)
    z = np.random.RandomState(0).standard_normal((8, config.latent_size)).astype(np.float32)
    modes = {"default": contextlib.nullcontext, "deterministic": precision.deterministic_cudnn}
    for dtype in (torch.float32, torch.bfloat16):
        net = SynthesisNetwork(params=params, config=config, compute_dtype=dtype, device="cuda")
        for phase in ("off", "on"):
            chip_smoke.set_phase(phase)
            times = {name: [] for name in modes}
            repeats = {}
            for name in ("default", "deterministic", "deterministic", "default"):
                with modes[name]():
                    times[name].append(round(chip_smoke.time_ms(
                        lambda: net.device_images_from_vectors(z), 300.0), 3))
                    frames = [net.images_from_vectors(z) for _ in range(3)]
                repeats[name] = all(np.array_equal(frames[0], f) for f in frames[1:])
            print(f"{str(dtype).split('.')[-1]} phase path {phase}, batch 8: ms per batch "
                  f"{times}; the batch repeats bit for bit {repeats}", flush=True)
        del net
        torch.cuda.empty_cache()
    chip_smoke.set_phase("off")


if __name__ == "__main__":
    main()
