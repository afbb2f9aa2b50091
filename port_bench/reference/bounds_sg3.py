"""
The yardstick of kernel F, StyleGAN3's filtered leaky ReLU: each launch's
least time on the H100 (bytes over HBM bandwidth, or operations over the
fp32 peak, whichever is larger; the peaks of bounds.py), from the layer's
shapes alone, so it reads the same work whatever implements F.

Per launch of a layer with B rows, C channels, input side h (the conv's
output, in_size + k - 1), upsampled side U = h * up + pads - up_taps + 1 and
output side s: bytes, fp32 input, bias and output read or written once,
4 (B C h^2 + C + B C s^2); multiply-adds of the separable polyphase filters,
up_taps / up per upsampled sample on each axis and down_taps per downsampled
sample on each axis, B C ((U h + U^2) up_taps / up + (s U + s^2) down_taps);
operations twice that. At 1024px a frame is 22.3 GMAC (L10 5.87).
"""

import re
from typing import Any, Dict, List, Tuple

from port_bench.reference.bounds import FP32_BYTES, bound_s
from port_bench.reference.stylegan3 import layers_of

# kernel F's CUDA function name in a device trace
KERNEL_PATTERN = r"filtered_lrelu_kernel"


def f_layers(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The layers that launch F: all but ToRGB."""
    return [spec for spec in layers_of(config) if not spec["torgb"]]


def f_macs(spec: Dict[str, Any], rows: int) -> int:
    h = spec["in_size"] + spec["kernel"] - 1
    up_taps, down_taps = len(spec["fu"]), len(spec["fd"])
    u = h * spec["up"] + sum(spec["padding"]) - up_taps + 1
    s = spec["out_size"]
    per_plane = (u * h + u * u) * up_taps // spec["up"] + (s * u + s * s) * down_taps
    return rows * spec["out_channels"] * per_plane


def f_bytes(spec: Dict[str, Any], rows: int) -> int:
    h = spec["in_size"] + spec["kernel"] - 1
    c, s = spec["out_channels"], spec["out_size"]
    return FP32_BYTES * (rows * c * h * h + c + rows * c * s * s)


def forward_launches(config: Dict[str, Any], rows: int) -> List[Tuple[str, float]]:
    """("F", bound seconds) of every launch of one synthesis forward."""
    return [("F", bound_s(f_bytes(spec, rows), 2 * f_macs(spec, rows)))
            for spec in f_layers(config)]


def is_f(kernel_name: str) -> bool:
    return re.search(KERNEL_PATTERN, kernel_name) is not None
