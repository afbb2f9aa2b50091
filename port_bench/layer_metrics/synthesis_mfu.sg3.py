"""The StyleGAN3 render window's share of the card's fp32 peak (67 TFLOP/s
outside the tensor cores): 2 x (conv + ToRGB + filtered-ReLU multiply-adds
of a frame, counted from the configuration's shapes,
port_bench/reference/opcount_sg3.py) x frames delivered / window seconds,
in percent."""

from port_bench.reference.bounds import FP32_FLOPS_PER_S
from port_bench.reference.opcount_sg3 import synthesis_flops_per_frame


def read(ctx):
    if not ctx.frames or ctx.window_s <= 0:
        return None
    flops = synthesis_flops_per_frame(ctx.config) * ctx.frames
    return 100.0 * flops / ctx.window_s / FP32_FLOPS_PER_S
