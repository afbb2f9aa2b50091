"""
Seeded StyleGAN3-T weights, made on the device in one draw and written in
the tree the program and the plain reference both take: the official
state_dict names nested at the dots (synthesis.L10_1044_81.weight is
tree["synthesis"]["L10_1044_81"]["weight"]), FC weights [out, in] as NVlabs
stores them. The configuration file names the scales under "assumed".
"""

import math
from typing import Any, Dict, List, Tuple

import torch

from port_bench.harness.weights import draw_seed
from port_bench.reference.stylegan3 import layers_of

Params = Dict[str, Any]

SMALL = 0.2  # biases and the affines' biases around their NVlabs values
INPUT_AFFINE = 0.2  # the input's affine weight (NVlabs starts it at 0)
W_AVG = 0.5
MAGNITUDE_LOG = 0.2  # magnitude_ema = exp(0.2 N(0, 1))

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def leaf_shapes(config: Dict[str, Any]) -> List[Leaf]:
    """(path, shape, how) of every drawn leaf, in draw order; `how` names the
    transform of its N(0, 1) draw (`make_leaf`)."""
    dl = config["dlatent_size"]
    leaves: List[Leaf] = []
    fan_in = config["latent_size"]
    for i in range(config["mapping_layers"]):
        leaves.append((("mapping", f"fc{i}", "weight"), (dl, fan_in), "mapping_weight"))
        leaves.append((("mapping", f"fc{i}", "bias"), (dl,), "mapping_bias"))
        fan_in = dl
    leaves.append((("mapping", "w_avg"), (dl,), "w_avg"))
    specs = layers_of(config)
    channels = specs[0]["input"]["channels"]
    inp = ("synthesis", "input")
    leaves.append((inp + ("weight",), (channels, channels), "unit"))
    leaves.append((inp + ("affine", "weight"), (4, dl), "input_affine"))
    leaves.append((inp + ("freqs",), (channels, 2), "freqs"))
    leaves.append((inp + ("phases",), (channels,), "phases"))
    for spec in specs:
        cin, cout, k = spec["in_channels"], spec["out_channels"], spec["kernel"]
        base = ("synthesis", spec["name"])
        leaves.append((base + ("weight",), (cout, cin, k, k), "unit"))
        leaves.append((base + ("bias",), (cout,), "small"))
        leaves.append((base + ("magnitude_ema",), (), "magnitude"))
        leaves.append((base + ("affine", "weight"), (cin, dl), "unit"))
        leaves.append((base + ("affine", "bias"), (cin,), "one_plus_small"))
    return leaves


def make_leaf(draw: torch.Tensor, how: str, config: Dict[str, Any]) -> torch.Tensor:
    """A leaf from its N(0, 1) draw."""
    if how == "unit":
        return draw
    if how == "mapping_weight":
        return draw / config["mapping_lrmul"]
    if how == "mapping_bias":  # stored / lrmul, so SMALL at run time
        return draw * (SMALL / config["mapping_lrmul"])
    if how == "w_avg":
        return draw * W_AVG
    if how == "small":
        return draw * SMALL
    if how == "one_plus_small":
        return 1.0 + draw * SMALL
    if how == "magnitude":
        return torch.exp(draw * MAGNITUDE_LOG)
    if how == "input_affine":
        return draw * INPUT_AFFINE
    if how == "freqs":  # NVlabs' disc: randn / (r exp(r^2)^0.25) x bandwidth
        radii = draw.square().sum(dim=1, keepdim=True).sqrt()
        return draw / (radii * radii.square().exp().pow(0.25)) * config["first_cutoff"]
    if how == "phases":  # uniform in [-0.5, 0.5) through the normal CDF
        return 0.5 * torch.erf(draw / math.sqrt(2.0))
    raise ValueError(how)


def generator_params(config: Dict[str, Any], seed: int, device: Any, stream: int = 0) -> Params:
    """The tree of one network from one `torch.randn` on `device`, plus the
    fixed leaves: the input's transform (the identity) and its affine's bias
    (1, 0, 0, 0)."""
    leaves = leaf_shapes(config)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, stream))
    flat = torch.randn((total,), generator=gen, device=device, dtype=torch.float32)
    tree: Params = {}

    def put(path: Tuple[str, ...], leaf: torch.Tensor) -> None:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    offset = 0
    for path, shape, how in leaves:
        count = math.prod(shape)
        put(path, make_leaf(flat[offset:offset + count].view(shape), how, config))
        offset += count
    put(("synthesis", "input", "transform"), torch.eye(3, device=device))
    put(("synthesis", "input", "affine", "bias"),
        torch.tensor([1.0, 0.0, 0.0, 0.0], device=device))
    return tree

