#!/usr/bin/env python3
"""
Where the GPU time of one projection step of the port goes, at 1024px
config-f: the yardstick for work on the projector
(gance_tpu_torch/projection/projector.py).

    python3 tools/time_torch_projection.py [--batch 4] [--dtype float32|bfloat16] \
        [--phase off|on] [--repeats 5] [--steps 3]

The network is config-f with `chip_smoke.py`'s seeded weights (`smoke_params`:
non-zero noise strengths), the metric the random VGG16 at 256px, the targets
the network's own frames (`chip_smoke.own_frames`), w the dlatent average and
the planes seeded. It prints, beside the card's name and power limit:
  * one step taken apart, by CUDA events, into the pieces that
    `Projector._loss_and_gradients` and `Projector._step` run, in their order:
    synthesis forward; VGG16 forward on the synthesized images (the 4x4
    average pool included); VGG16 forward on the targets; the distance, the
    noise regulariser and the backward to w and the planes; Adam and the
    noise normalisation. Mean over --repeats steps after a warm-up step,
    with the whole step (`Projector._step`) timed the same way beside it;
  * torch.profiler over --steps whole steps: device time per kernel name and
    per family (each of the port's kernels A-E, convolutions, elementwise,
    copies, other) in ms per step and as a share of the device time, and the
    device's idle share, 1 - device time / step time.

Needs a CUDA GPU; exits 1 without one.
"""

import argparse
import collections
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import SEED, own_frames, seeded_planes, smoke_params  # noqa: E402

FAMILIES = (
    ("A fused_bias_noise_lrelu", ("bias_noise_lrelu",)),
    ("B upsample2x_blur", ("upsample2x_blur",)),
    ("C blur4_separable_pad11", ("blur4_kernel", "blur4_phases_kernel")),
    ("D stencil_blur4_valid", ("stencil_kernel",)),
    ("E phase_conv1_torgb", ("phase_f32_kernel", "phase_bf16_kernel")),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "cutlass", "sm90", "sm80", "winograd")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "where", "clamp", "floor", "pool")),
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
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--phase", choices=("off", "on"), default="off",
                        help="the polyphase top block (GANCE_TPU_PHASE1024)")
    parser.add_argument("--repeats", type=int, default=5, help="steps timed piece by piece")
    parser.add_argument("--steps", type=int, default=3, help="profiled steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    os.environ["GANCE_TPU_PHASE1024"] = args.phase

    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops.cuda import build
    from gance_tpu_torch.projection import lpips
    from gance_tpu_torch.projection.projector import (
        Projector,
        ProjectorSettings,
        _noise_regularization,
        _normalize_noises,
        from_jax_layout,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    build.build_all()
    config = GeneratorConfig()
    projector = Projector(smoke_params(SEED, config), config, device="cuda",
                          settings=ProjectorSettings(compute_dtype=args.dtype, num_steps=1000))
    targets, _ = own_frames(projector.params, config, args.batch, SEED + 15)
    target_proc = projector._target_proc(targets)
    perceptual = projector._perceptual_on_device()
    w = projector.dlatent_avg.expand(args.batch, -1).clone().requires_grad_(True)
    planes = [from_jax_layout(p, projector.device).requires_grad_(True)
              for p in seeded_planes(projector, args.batch, SEED + 13)]
    opt = torch.optim.Adam([w] + planes, lr=0.1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    size = projector.settings.perceptual_size
    weight = projector.settings.regularize_noise_weight

    def pieces(step: int) -> list:
        """One step in the pieces of `_loss_and_gradients` and `_step`, an
        event after each; the jitter at this step's strength."""
        settings = projector.settings
        t = step / settings.num_steps
        strength = (projector.dlatent_std * settings.initial_noise_factor
                    * max(0.0, 1.0 - t / settings.noise_ramp_length) ** 2)
        jitter = torch.randn(w.shape, generator=gen, device="cuda") * strength
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        events[0].record()
        leaves = [w.detach().requires_grad_(True)] + [p.detach().requires_grad_(True)
                                                      for p in planes]
        images = projector._synthesis_from_w(leaves[0] + jitter, leaves[1:])
        events[1].record()
        proc = lpips.downsample_to(images.permute(0, 3, 1, 2), size).contiguous()
        feats_a = lpips.vgg_features(perceptual, proc)
        events[2].record()
        feats_b = lpips.vgg_features(perceptual, target_proc)
        events[3].record()
        dist = lpips.feature_distance(perceptual, feats_a, feats_b)
        loss = torch.sum(dist + _noise_regularization(leaves[1:]) * weight)
        grads = torch.autograd.grad(loss, leaves)
        events[4].record()
        for leaf, grad in zip([w] + planes, grads):
            leaf.grad = grad
        for group in opt.param_groups:
            group["lr"] = 0.01
        opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for plane, normalized in zip(planes, _normalize_noises(planes)):
                plane.copy_(normalized)
        events[5].record()
        return events

    labels = ("synthesis forward", "VGG16 forward, synthesized", "VGG16 forward, targets",
              "distance + regulariser + backward", "Adam + noise normalisation")
    pieces(0)
    torch.cuda.synchronize()
    split = collections.Counter()
    for step in range(1, args.repeats + 1):
        events = pieces(step)
        events[-1].synchronize()
        for i, label in enumerate(labels):
            split[label] += events[i].elapsed_time(events[i + 1]) / args.repeats

    def whole(step: int) -> None:
        projector._step(w, planes, opt, target_proc, step, gen, perceptual,
                        projector.settings.initial_noise_factor)

    whole(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for step in range(1, args.repeats + 1):
        whole(step)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / args.repeats

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for step in range(args.steps):
            whole(100 + step)
        torch.cuda.synchronize()
    per_kernel = collections.Counter()
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[event.key] += event.self_device_time_total / 1e3 / args.steps
    device_ms = sum(per_kernel.values())

    print(f"{card}; torch {torch.__version__}; projection step at {config.resolution}px config-f, "
          f"batch {args.batch}, {args.dtype}, phase path {args.phase}, VGG16 at {size}px")
    print(f"whole step (Projector._step, CUDA events, unprofiled): {step_ms:.3f} ms = "
          f"{args.batch / step_ms * 1e3:.3f} frame-steps/s")
    total = sum(split.values())
    for label in labels:
        print(f"piece {label}: {split[label]:.3f} ms ({split[label] / total:.3f})")
    print(f"pieces summed: {total:.3f} ms")
    if device_ms == 0:
        print("the profiler recorded no device time")
        sys.exit(1)
    print(f"device time per step (profiler): {device_ms:.3f} ms; idle share "
          f"{max(0.0, 1 - device_ms / step_ms):.3f}")
    families = collections.Counter()
    for name, ms in per_kernel.items():
        families[family(name)] += ms
    for label, ms in families.most_common():
        print(f"family {label}: {ms:.3f} ms per step ({ms / device_ms:.3f})")
    for name, ms in per_kernel.most_common(12):
        print(f"kernel {ms:.3f} ms ({ms / device_ms:.3f}) {family(name)}: {name[:110]}")


if __name__ == "__main__":
    main()
