#!/usr/bin/env python3
"""
How far apart can two correct fp32 evaluations of one train step's gradients
be? Runs `chip_smoke.py`'s parity step (32px, config-f widths, batch 4, the
same seed and draws) on the CPU twice, in fp32 and in float64, and prints,
for the D step (with and without R1) and the G step (with and without path
length): the losses, the whole network's norm-wise relative difference, and
the worst leaves by norm-wise difference and by max-abs difference over the
leaf's largest magnitude.

    python3 tools/gradient_conditioning.py

The float64 run is the port's own code with `Tensor.float` made to keep
float64 (the kernels' twins and the model cast with `.float()`) and the
compute dtype set to float64. A lrelu input within fp32 noise of 0 takes the
other slope in one of the runs; at the discriminator's 4x4 bottleneck one
such element moves every upstream gradient, which is what this measures.
"""

import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from gance_tpu_torch.models.stylegan2 import GeneratorConfig  # noqa: E402
from gance_tpu_torch.parallel import training as T  # noqa: E402


def step_gradients(state, reals, draws, config, tc, dtype) -> Dict[Tuple[str, bool], tuple]:
    def cast(tree):
        return T.tree_from_leaves([(p, v.detach().to(dtype).requires_grad_(True))
                                   for p, v in T.tree_leaves(tree)])

    def cast_draw(value):
        if isinstance(value, list):
            return [cast_draw(v) for v in value]
        return value.to(dtype) if value.is_floating_point() else value

    g, d = cast(state.g_params), cast(state.d_params)
    draws = T.StepDraws(**{k: cast_draw(v) for k, v in vars(draws).items()})
    out = {}
    for r1 in (False, True):
        out[("D", r1)] = T.d_step_gradients(g, d, reals.to(dtype), draws, r1, config, tc)
    for pl in (False, True):
        out[("G", pl)] = T.g_step_gradients(g, d, draws, state.pl_mean.to(dtype), pl, config, tc)
    return out


def main() -> None:
    config = GeneratorConfig(resolution=32)
    tc = T.TrainingConfig()
    draws = T.draw_step(chip_smoke.SEED, 0, chip_smoke.TRAIN_BATCH, config, tc, "cpu")
    reals = torch.from_numpy(
        chip_smoke.SeededImages(chip_smoke.SEED, 8, 32).images[:chip_smoke.TRAIN_BATCH])
    state = T.init_training_state(chip_smoke.SEED, config, tc, device="cpu")
    fp32 = step_gradients(state, reals, draws, config, tc, torch.float32)

    fp32_cast = torch.Tensor.float
    torch.Tensor.float = lambda self: self if self.dtype == torch.float64 else fp32_cast(self)
    T._DTYPES["float32"] = torch.float64
    try:
        fp64 = step_gradients(state, reals, draws, config, tc, torch.float64)
    finally:
        torch.Tensor.float = fp32_cast
        T._DTYPES["float32"] = torch.float32

    for key, (grads, metrics) in fp32.items():
        exact, exact_metrics = fp64[key]
        params = state.d_params if key[0] == "D" else state.g_params
        rows: List[Tuple[float, float, str]] = []
        for (path, _), a, b in zip(T.tree_leaves(params), grads, exact):
            if float(b.norm()) == 0.0:
                continue
            diff = a.double() - b
            rows.append((float(diff.norm() / b.norm()), float(diff.abs().max() / b.abs().max()), path))
        whole = torch.cat([g.double().reshape(-1) for g in grads])
        whole_exact = torch.cat([g.reshape(-1) for g in exact])
        name = f"{key[0]} step, {'R1' if key[0] == 'D' else 'PL'} {'on' if key[1] else 'off'}"
        print(f"{name}: losses fp32 {[round(float(v), 7) for v in metrics.values()]} "
              f"float64 {[round(float(v), 7) for v in exact_metrics.values()]}")
        print(f"  whole net norm-wise {float((whole - whole_exact).norm() / whole_exact.norm()):.3g}; "
              f"worst leaves norm-wise "
              f"{[(f'{r[0]:.3g}', r[2]) for r in sorted(rows, reverse=True)[:3]]}; by max-abs/max "
              f"{[(f'{r[1]:.3g}', r[2]) for r in sorted(rows, key=lambda r: -r[1])[:3]]}")


if __name__ == "__main__":
    main()
