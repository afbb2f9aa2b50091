"""
Carry generator weights over from gance_tpu's params tree to the port's.

gance_tpu keeps activations NHWC and conv weights HWIO, and moves the TF
pickle's const and noise buffers to NHWC. `params_from_reference` takes that
tree, as numpy arrays, and returns the port's tree (OIHW conv weights, NCHW
const and noise buffers), so that both packages compute the same function.
"""

from typing import Any, Dict

import numpy as np

Params = Dict[str, Any]


def _synthesis_from_reference(tree: Params) -> Params:
    out: Params = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _synthesis_from_reference(value)
            continue
        value = np.asarray(value, dtype=np.float32)
        if key == "weight" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif value.ndim == 4 and (key == "const" or key.startswith("noise")):
            value = value.transpose(0, 3, 1, 2)  # NHWC -> NCHW
        out[key] = value.copy()  # C-contiguous; keeps 0-d strengths 0-d
    return out


def params_from_reference(tree: Params) -> Params:
    """gance_tpu generator params (numpy, NHWC/HWIO) -> the port's params."""
    return {
        "mapping": {
            name: {k: np.asarray(v, dtype=np.float32) for k, v in layer.items()}
            for name, layer in tree["mapping"].items()
        },
        "synthesis": _synthesis_from_reference(tree["synthesis"]),
        "dlatent_avg": np.asarray(tree["dlatent_avg"], dtype=np.float32),
    }
