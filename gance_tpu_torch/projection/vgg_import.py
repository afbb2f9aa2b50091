"""
Import pretrained VGG16 weights for true LPIPS projection: a host-only copy
of gance_tpu/projection/vgg_import.py for the port.

The reference's projector uses NVlabs' vgg16_zhang_perceptual pickle. Without
one the projector uses deterministic random features (projection/lpips.py);
when a user brings weights, three import paths produce the .npz layout
lpips.load_vgg_params expects:

  * the NVlabs `vgg16_zhang_perceptual.pkl` itself (a dnnlib.tflib Network),
    read through the port's capture-only unpickler
    (models/pickle_loader.py::read_network_pickle); conv and learned
    per-layer linear weights are told apart by SHAPE (robust to TF variable
    naming): 3x3 HWIO kernels chained along the VGG16 cin->cout topology,
    1x1x(C)x1 kernels are Zhang's lin layers;
  * a torchvision vgg16 state_dict (.pth / .pt: features.N.{weight,bias} with
    OIHW conv kernels) -> block{b}_conv{c}_{w,b} HWIO arrays;
  * an .npz already in this naming, passed through unchanged.
"""

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from gance_tpu_torch.projection.lpips import (
    VGG16_BLOCKS,
    ZHANG_INPUT_SCALE,
    ZHANG_INPUT_SHIFT,
)

# torchvision vgg16 'features' conv layer indices per block (pools between).
_TORCHVISION_CONV_INDICES = (
    (0, 2),
    (5, 7),
    (10, 12, 14),
    (17, 19, 21),
    (24, 26, 28),
)


def convert_torchvision_vgg16(state_dict: Dict[str, "np.ndarray"]) -> Dict[str, np.ndarray]:
    """
    Convert a torchvision vgg16 `features` state_dict (tensors or ndarrays, conv
    weights OIHW) to the LPIPS param layout (HWIO).
    """
    params: Dict[str, np.ndarray] = {}
    for block, conv_indices in enumerate(_TORCHVISION_CONV_INDICES):
        expected_out, n_convs = VGG16_BLOCKS[block]
        if len(conv_indices) != n_convs:
            raise AssertionError("torchvision layout table out of sync")
        for conv, layer_idx in enumerate(conv_indices):
            weight = np.asarray(state_dict[f"features.{layer_idx}.weight"])
            bias = np.asarray(state_dict[f"features.{layer_idx}.bias"])
            if weight.ndim != 4:
                raise ValueError(f"features.{layer_idx}.weight is not a conv kernel")
            if weight.shape[0] != expected_out:
                raise ValueError(
                    f"features.{layer_idx}: expected {expected_out} out channels, "
                    f"got {weight.shape[0]}"
                )
            # OIHW -> HWIO
            params[f"block{block}_conv{conv}_w"] = np.transpose(
                weight, (2, 3, 1, 0)
            ).astype(np.float32)
            params[f"block{block}_conv{conv}_b"] = bias.astype(np.float32)
    return params


def _natural_key(name: str) -> Tuple:
    """
    Sort key treating digit runs numerically, so TF auto-suffixed scopes order
    as Conv2D < Conv2D_2 < Conv2D_10 (lexicographic sort would scramble the
    shape-identical 512->512 kernels into the wrong forward order — a silent
    feature corruption, since every shape check still passes).
    """
    import re

    return tuple(
        int(part) if part.isdigit() else part
        for part in re.split(r"(\d+)", name)
    )


def _vgg16_conv_chain() -> List[Tuple[int, int]]:
    """The 13 (cin, cout) pairs of the VGG16 conv stack, in forward order."""
    chain: List[Tuple[int, int]] = []
    cin = 3
    for cout, n_convs in VGG16_BLOCKS:
        for _ in range(n_convs):
            chain.append((cin, cout))
            cin = cout
    return chain


def convert_nvlabs_lpips(variables: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """
    Convert the variables of a captured NVlabs LPIPS network
    (`vgg16_zhang_perceptual.pkl`) to the LPIPS param layout.

    Classification is by SHAPE, not name (TF variable naming in that pickle is an
    implementation detail of its embedded build source, which the capture-only
    unpickler never executes):
      * (3, 3, cin, cout) tensors are the VGG conv kernels (TF is HWIO already);
        they are assigned along the VGG16 cin->cout chain, name-sorted within
        identical (cin, cout) signatures (TF names like conv3_2/conv3_3 sort in
        forward order);
      * each kernel's bias is the 1-D tensor sharing its name scope (dirname);
      * (1, 1, C, 1) or (C, 1) tensors are Zhang's learned `lin` layers, keyed to
        feature blocks by C (the two C=512 entries name-sort to blocks 3, 4).

    The Zhang ScalingLayer constants are attached as input_shift/input_scale so
    distances are computed on the distribution the pretrained VGG expects.
    """
    scopes: Dict[str, Dict[str, np.ndarray]] = {}
    for name, value in variables.items():
        scope = name.rsplit("/", 1)[0] if "/" in name else name
        scopes.setdefault(scope, {})[name] = np.asarray(value)

    convs: List[Tuple[str, np.ndarray, np.ndarray]] = []  # (scope, kernel, bias)
    lins: List[Tuple[str, np.ndarray]] = []  # (scope, (C,) weights)
    for scope, members in scopes.items():
        kernel = None
        bias = None
        lin = None
        for name, value in members.items():
            if value.ndim == 4 and value.shape[0] == value.shape[1] == 3:
                kernel = value
            elif value.ndim == 4 and value.shape[:2] == (1, 1) and value.shape[3] == 1:
                lin = value.reshape(-1)
            elif value.ndim == 2 and value.shape[1] == 1:
                lin = value.reshape(-1)
            elif value.ndim == 1:
                bias = value
        if kernel is not None:
            if bias is None:
                bias = np.zeros((kernel.shape[3],), np.float32)
            if bias.shape[0] != kernel.shape[3]:
                raise ValueError(
                    f"{scope}: bias length {bias.shape[0]} != kernel cout {kernel.shape[3]}"
                )
            convs.append((scope, kernel, bias))
        elif lin is not None:
            lins.append((scope, lin))

    params: Dict[str, np.ndarray] = {}

    # --- assign conv kernels along the VGG16 topology ---
    chain = _vgg16_conv_chain()
    remaining = sorted(convs, key=lambda entry: _natural_key(entry[0]))
    position = 0
    for block, (cout, n_convs) in enumerate(VGG16_BLOCKS):
        for conv in range(n_convs):
            cin_expected, cout_expected = chain[position]
            position += 1
            match = next(
                (
                    entry
                    for entry in remaining
                    if entry[1].shape[2:] == (cin_expected, cout_expected)
                ),
                None,
            )
            if match is None:
                raise ValueError(
                    f"LPIPS pickle lacks a ({cin_expected}->{cout_expected}) conv "
                    f"for block{block}_conv{conv}; scopes seen: "
                    f"{[entry[0] for entry in convs]}"
                )
            remaining.remove(match)
            params[f"block{block}_conv{conv}_w"] = match[1].astype(np.float32)
            params[f"block{block}_conv{conv}_b"] = match[2].astype(np.float32)
    if remaining:
        raise ValueError(
            f"Unassigned conv kernels in LPIPS pickle: {[e[0] for e in remaining]}"
        )

    # --- learned linear layers, keyed by channel count ---
    if lins:
        block_channels = [cout for cout, _ in VGG16_BLOCKS]  # 64,128,256,512,512
        unassigned = sorted(lins, key=lambda entry: _natural_key(entry[0]))
        for block, channels in enumerate(block_channels):
            match = next(
                (entry for entry in unassigned if entry[1].shape[0] == channels), None
            )
            if match is None:
                raise ValueError(
                    f"LPIPS pickle has lin layers but none with {channels} channels "
                    f"for block {block}"
                )
            unassigned.remove(match)
            params[f"lin{block}_w"] = match[1].astype(np.float32)
        if unassigned:
            raise ValueError(
                f"Unassigned lin layers in LPIPS pickle: {[e[0] for e in unassigned]}"
            )

    params["input_shift"] = ZHANG_INPUT_SHIFT.copy()
    params["input_scale"] = ZHANG_INPUT_SCALE.copy()
    return params


NVLABS_CONV_SCOPES: Tuple[str, ...] = (
    "conv1_1", "conv1_2",
    "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
)


def fabricate_nvlabs_lpips_variables(
    rng: "np.random.RandomState", lin_layout: str = "4d", he_scaled: bool = False
) -> Dict[str, np.ndarray]:
    """
    Fixture factory: the variables of a plausible `vgg16_zhang_perceptual.pkl`
    (3x3 HWIO conv kernels + biases in TF name scopes, Zhang's learned 1x1 lin
    layers), in the exact layout this module's importer accepts.

    :param lin_layout: "4d" -> (1, 1, C, 1) kernels, "2d" -> (C, 1).
    :param he_scaled: He-scale the conv filters (a usable random metric, for
        benches) instead of the tests' small-magnitude filters.
    """
    variables: Dict[str, np.ndarray] = {}
    cin = 3
    scope_names = iter(NVLABS_CONV_SCOPES)
    for cout, n_convs in VGG16_BLOCKS:
        for _ in range(n_convs):
            scope = next(scope_names)
            if he_scaled:
                kernel = rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))
                bias = np.zeros((cout,), np.float32)
            else:
                kernel = rng.randn(3, 3, cin, cout) * 0.01
                bias = rng.randn(cout) * 0.001
            variables[f"{scope}/weight"] = kernel.astype(np.float32)
            variables[f"{scope}/bias"] = np.asarray(bias, np.float32)
            cin = cout
    for i, channels in enumerate([64, 128, 256, 512, 512]):
        lin = np.abs(rng.randn(channels)).astype(np.float32)
        if lin_layout == "4d":
            variables[f"lin{i}/weight"] = lin.reshape(1, 1, channels, 1)
        else:
            variables[f"lin{i}/weight"] = lin.reshape(channels, 1)
    return variables


def load_nvlabs_lpips_pickle(path: Path) -> Dict[str, np.ndarray]:
    """
    Read `vgg16_zhang_perceptual.pkl` through the capture-only unpickler (no TF, no
    code execution, models/pickle_loader.py) and convert to LPIPS params.
    """
    from gance_tpu_torch.models.pickle_loader import read_network_pickle

    nets = read_network_pickle(Path(path))
    network = nets.generator_ema or nets.generator
    if network is None:
        raise ValueError(f"No network found in LPIPS pickle {path}")
    return convert_nvlabs_lpips(network.variables)


def import_vgg_weights(source: Path, destination_npz: Path) -> None:
    """
    Import VGG16 weights from an NVlabs LPIPS pickle, a torch checkpoint, or an
    npz into the npz file the projector consumes
    (`Projector(vgg_weights_path=...)`).
    """
    source = Path(source)
    if source.suffix == ".npz":
        from gance_tpu_torch.projection.lpips import load_vgg_params

        params = load_vgg_params(source)
    elif source.suffix == ".pkl":
        params = load_nvlabs_lpips_pickle(source)
    else:
        import torch

        loaded = torch.load(str(source), map_location="cpu", weights_only=True)
        state_dict = loaded.get("state_dict", loaded) if isinstance(loaded, dict) else loaded
        params = convert_torchvision_vgg16(
            {k: v.numpy() for k, v in state_dict.items() if k.startswith("features.")}
        )
    np.savez(str(destination_npz), **params)
