"""
Operations of the model, counted from its shapes (multiply-adds; an
operation count is twice that).

Synthesis: every 3x3 modulated conv at its output side, except each
block's up-conv, a transposed conv that does 9 products per input pixel, at
its input side; the 1x1 ToRGB convs. config-f: 238.3 GMAC of 3x3 convs a
frame at 1024px, 122.4 at 256px.
"""

import math
from typing import Any, Dict

from port_bench.reference.bounds import nf


def synthesis_conv_macs(config: Dict[str, Any]) -> int:
    """3x3 conv multiply-adds of one frame."""
    top = int(round(math.log2(config["resolution"])))
    macs = 16 * 9 * nf(config, 1) ** 2
    for res in range(3, top + 1):
        s, cin, cout = 2 ** res, nf(config, res - 2), nf(config, res - 1)
        macs += (s // 2) ** 2 * 9 * cin * cout  # Conv0_up, transposed, at its input side
        macs += s * s * 9 * cout * cout  # Conv1
    return macs


def synthesis_torgb_macs(config: Dict[str, Any]) -> int:
    top = int(round(math.log2(config["resolution"])))
    channels = config["num_channels"]
    macs = 16 * nf(config, 1) * channels
    for res in range(3, top + 1):
        macs += (2 ** res) ** 2 * nf(config, res - 1) * channels
    return macs


def synthesis_flops_per_frame(config: Dict[str, Any]) -> int:
    """2 x (conv + ToRGB) multiply-adds of one frame's forward."""
    return 2 * (synthesis_conv_macs(config) + synthesis_torgb_macs(config))

