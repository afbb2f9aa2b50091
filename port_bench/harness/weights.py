"""
Seeded generator weights, made on the device in one draw and written in the
port's parameter layout (the TF pickle's tree: OIHW conv weights, (in, out)
dense and style weights, (1, C, 4, 4) const, (1, 1, s, s) noise buffers).
The same tree is handed to the program and to the plain reference.
"""

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

# Scales of the N(0, 1) draw per kind of leaf (the configuration files name
# them under "assumed"): biases, style biases and noise strengths are not
# zero, so that every term of the layer equations moves the frames; ToRGB is
# scaled so that frames are not saturated at 0 or 255.
SMALL = 0.2
TORGB = 0.06
DLATENT_AVG = 0.5


def nf(config: Dict[str, Any], stage: int) -> int:
    """Feature maps at a stage (NVlabs nf())."""
    value = int(config["fmap_base"] / (2.0 ** (stage * config["fmap_decay"])))
    return int(min(max(value, config["fmap_min"]), config["fmap_max"]))


def resolution_log2(config: Dict[str, Any]) -> int:
    return int(round(math.log2(config["resolution"])))


def leaf_shapes(config: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf, in draw order."""
    leaves: List[Tuple[Tuple[str, ...], Tuple[int, ...], float]] = []
    fan_in, lrmul = config["latent_size"], config["mapping_lrmul"]
    for i in range(config["mapping_layers"]):
        fmaps = config["dlatent_size"] if i == config["mapping_layers"] - 1 else config["mapping_fmaps"]
        leaves.append((("mapping", f"Dense{i}", "weight"), (fan_in, fmaps), 1.0 / lrmul))
        leaves.append((("mapping", f"Dense{i}", "bias"), (fmaps,), 1.0))
        fan_in = fmaps
    dl = config["dlatent_size"]

    def conv(key: str, name: str, k: int, cin: int, cout: int, noise: bool, rgb: bool = False) -> None:
        base = ("synthesis", key, name)
        leaves.append((base + ("weight",), (cout, cin, k, k), TORGB if rgb else 1.0))
        leaves.append((base + ("mod_weight",), (dl, cin), 1.0))
        leaves.append((base + ("mod_bias",), (cin,), SMALL))
        leaves.append((base + ("bias",), (cout,), SMALL))
        if noise:
            leaves.append((base + ("noise_strength",), (), SMALL))

    channels = config["num_channels"]
    leaves.append((("synthesis", "4x4", "Const", "const"), (1, nf(config, 1), 4, 4), 1.0))
    conv("4x4", "Conv", 3, nf(config, 1), nf(config, 1), True)
    conv("4x4", "ToRGB", 1, nf(config, 1), channels, False, rgb=True)
    top = resolution_log2(config)
    for res in range(3, top + 1):
        key, cin, cout = f"{2**res}x{2**res}", nf(config, res - 2), nf(config, res - 1)
        conv(key, "Conv0_up", 3, cin, cout, True)
        conv(key, "Conv1", 3, cout, cout, True)
        conv(key, "ToRGB", 1, cout, channels, False, rgb=True)
    for layer in range(2 * top - 3):
        size = 2 ** ((layer + 5) // 2)
        leaves.append((("synthesis", "noise", f"noise{layer}"), (1, 1, size, size), 1.0))
    leaves.append((("dlatent_avg",), (dl,), DLATENT_AVG))
    return leaves


def draw_seed(seed: int, stream: int) -> int:
    """A generator seed for draw stream `stream` of a run's `--seed`."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(2, np.uint32)
               .view(np.uint64)[0] >> 1)


def generator_params(config: Dict[str, Any], seed: int, device: Any, stream: int = 0) -> Params:
    """The tree of one network, drawn with one `torch.randn` on `device`;
    each leaf is a view of that draw, scaled."""
    leaves = leaf_shapes(config)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, stream))
    flat = torch.randn((total,), generator=gen, device=device, dtype=torch.float32)
    tree: Params = {}
    offset = 0
    for path, shape, scale in leaves:
        count = math.prod(shape)
        leaf = flat[offset:offset + count].view(shape)
        if scale != 1.0:
            leaf.mul_(scale)
        offset += count
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
