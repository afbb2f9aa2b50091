"""
The yardstick of the port's kernels: the H100's published peaks, and each
launch's least time on them (bytes over HBM bandwidth, or operations over
peak, whichever is larger). A frozen copy of chip_smoke.py phase 2's
arithmetic (`bound_ms` and the bytes and operations it counts per kernel),
applied to the launches of one synthesis forward.

Counting, as there, in fp32: every input byte read once and every output
byte written once. A (bias + noise + leaky ReLU): x read and written, the
noise plane read; 5 operations an element. B (2x upsample + FIR on RGB): x
read, 4x its elements written; 16 operations an input element. C (the
[1,3,3,1] blur of the transposed conv's four output phases where they lie):
the four phases read, the blurred output written; 16 operations an output
element.
"""

import math
import re
from typing import Any, Dict, List, Tuple

# NVIDIA H100 SXM data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
FP32_BYTES = 4

# kernel family -> pattern of its CUDA function name in a device trace
KERNEL_PATTERNS = {
    "A": r"bias_noise_lrelu_kernel",
    "B": r"upsample2x_blur_kernel",
    "C": r"blur4_phases_kernel|\bblur4_kernel",
    "D": r"\bstencil_kernel",
    "E": r"phase_(f32|bf16)_kernel",
}


def bound_s(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def nf(config: Dict[str, Any], stage: int) -> int:
    value = int(config["fmap_base"] / (2.0 ** (stage * config["fmap_decay"])))
    return int(min(max(value, config["fmap_min"]), config["fmap_max"]))


def a_bound(b: int, c: int, s: int) -> float:
    numel = b * c * s * s
    return bound_s(2 * numel * FP32_BYTES + s * s * 4, 5 * numel)


def b_bound(b: int, channels: int, s: int) -> float:
    numel = b * channels * s * s
    return bound_s(5 * numel * FP32_BYTES, 16 * numel)


def c_bound(b: int, c: int, s: int) -> float:
    """C at an up-conv of output side s: its input is the transposed conv's
    (s + 1)-sided output as four phase planes."""
    outs = b * c * s * s
    half = s // 2
    read = sum(b * c * (half + 1 - i) * (half + 1 - j) for i in (0, 1) for j in (0, 1))
    return bound_s((read + outs) * FP32_BYTES, 16 * outs)


def forward_launches(config: Dict[str, Any], rows: int) -> List[Tuple[str, float]]:
    """(kernel family, bound seconds) of every launch of one fp32 synthesis
    forward of `rows` frames on the standard path (no phase top block)."""
    top = int(round(math.log2(config["resolution"])))
    channels = config["num_channels"]
    out = [("A", a_bound(rows, nf(config, 1), 4))]
    for res in range(3, top + 1):
        s, cout = 2 ** res, nf(config, res - 1)
        out.append(("C", c_bound(rows, cout, s)))
        out.append(("A", a_bound(rows, cout, s)))
        out.append(("A", a_bound(rows, cout, s)))
        out.append(("B", b_bound(rows, channels, s // 2)))
    return out


def family_of(kernel_name: str) -> str:
    for family, pattern in KERNEL_PATTERNS.items():
        if re.search(pattern, kernel_name):
            return family
    return ""
