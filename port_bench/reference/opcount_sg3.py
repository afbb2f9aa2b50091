"""
Operations of a StyleGAN3-T frame, counted from its shapes (multiply-adds;
an operation count is twice that): every 3x3 modulated conv at its output
side with full padding ((in_size + 2)^2 x 9 x Cin x Cout), the 1x1 ToRGB,
and kernel F's separable polyphase filters (bounds_sg3.f_macs). 1024px:
285.1 GMAC of 3x3 convs, 0.1 of ToRGB, 22.3 of filters a frame.
"""

from typing import Any, Dict

from port_bench.reference.bounds_sg3 import f_layers, f_macs
from port_bench.reference.stylegan3 import layers_of


def conv_macs(config: Dict[str, Any], torgb: bool = False) -> int:
    """The 3x3 convs' multiply-adds of one frame (ToRGB's with `torgb`)."""
    total = 0
    for spec in layers_of(config):
        if spec["torgb"] == torgb:
            side = spec["in_size"] + spec["kernel"] - 1
            total += side * side * spec["kernel"] ** 2 * spec["in_channels"] * spec["out_channels"]
    return total


def filter_macs(config: Dict[str, Any]) -> int:
    return sum(f_macs(spec, 1) for spec in f_layers(config))


def synthesis_flops_per_frame(config: Dict[str, Any]) -> int:
    """2 x (conv + ToRGB + filter multiply-adds) of one frame's forward."""
    return 2 * (conv_macs(config) + conv_macs(config, torgb=True) + filter_macs(config))
