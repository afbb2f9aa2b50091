"""
Perceptual distance for latent projection: the counterpart of
gance_tpu/projection/lpips.py on NCHW tensors.

The weights are the JAX package's: `random_vgg_params(seed)` (a fixed-seed
He-initialised VGG16, the default metric, byte-equal to JAX's) or
`load_vgg_params(path)` (an `.npz` in the block{b}_conv{c}_{w,b} layout, or the
NVlabs `vgg16_zhang_perceptual.pkl` through projection/vgg_import.py). Both
return numpy arrays with HWIO conv kernels; `vgg_params_to_device` moves them
to the device once, conv kernels transposed to OIHW, and the functions below
take that dict.

Distance (LPIPS form): VGG16 features per block (3x3 SAME convs with ReLU, a
2x2 max pool between blocks), each unit-normalised over channels, squared
differences weighted by Zhang's `lin{b}_w` when present, summed over
channels, averaged over space and summed over blocks in ascending order.
Zhang's input shift and scale apply first when the params carry them. The
convolutions are plain cuDNN calls in fp32, whatever dtype synthesis ran in.
"""

from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.precision import apply_conv_precision

# VGG16 conv layout: (out_channels, convs_per_block)
VGG16_BLOCKS: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# Layers whose activations feed the distance (outputs of each block, pre-pool).
DEFAULT_FEATURE_BLOCKS: Tuple[int, ...] = (0, 1, 2, 3, 4)

# Zhang's ScalingLayer constants (lpips/networks_basic.py): map [-1, 1] RGB onto
# the ImageNet-normalized distribution the pretrained VGG expects.
ZHANG_INPUT_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
ZHANG_INPUT_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

VGGParams = Dict[str, torch.Tensor]


def random_vgg_params(seed: int = 0, in_channels: int = 3) -> Dict[str, np.ndarray]:
    """Fixed-seed He-initialized VGG16 conv weights (HWIO)."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}
    cin = in_channels
    for b, (cout, n_convs) in enumerate(VGG16_BLOCKS):
        for c in range(n_convs):
            fan_in = 3 * 3 * cin
            params[f"block{b}_conv{c}_w"] = (
                rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / fan_in)
            ).astype(np.float32)
            params[f"block{b}_conv{c}_b"] = np.zeros((cout,), np.float32)
            cin = cout
    return params


def load_vgg_params(path: Path) -> Dict[str, np.ndarray]:
    """
    Load perceptual-net weights: an .npz with the block{b}_conv{c}_{w,b} (+
    optional lin{b}_w / input_shift / input_scale) keys, or the NVlabs
    `vgg16_zhang_perceptual.pkl` directly (converted via projection/vgg_import.py).
    """
    path = Path(path)
    if path.suffix == ".pkl":
        from gance_tpu_torch.projection.vgg_import import load_nvlabs_lpips_pickle

        return load_nvlabs_lpips_pickle(path)
    blob = np.load(str(path))
    return {k: np.asarray(blob[k], np.float32) for k in blob.files}


def vgg_params_to_device(
    params: Dict[str, np.ndarray], device: Union[str, torch.device]
) -> VGGParams:
    """The numpy params as fp32 tensors on `device`, conv kernels HWIO -> OIHW."""
    out: VGGParams = {}
    for key, value in params.items():
        value = np.asarray(value, np.float32)
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return out


def vgg_features(
    params: VGGParams,
    images: torch.Tensor,
    feature_blocks: Sequence[int] = DEFAULT_FEATURE_BLOCKS,
) -> List[torch.Tensor]:
    """
    VGG16 forward collecting per-block features, in fp32.
    :param params: from `vgg_params_to_device`.
    :param images: (B, 3, H, W) float in [-1, 1].
    """
    apply_conv_precision()
    x = images.float()
    if "input_shift" in params:
        x = (x - params["input_shift"][None, :, None, None]) / params["input_scale"][
            None, :, None, None]
    feats: List[torch.Tensor] = []
    for b, (_, n_convs) in enumerate(VGG16_BLOCKS):
        for c in range(n_convs):
            x = F.relu(F.conv2d(x, params[f"block{b}_conv{c}_w"], params[f"block{b}_conv{c}_b"],
                                padding=1))
        if b in feature_blocks:
            feats.append(x)
        # 2x2 max pool between blocks (not after the last)
        if b < len(VGG16_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def lpips_distance(
    params: VGGParams,
    images_a: torch.Tensor,
    images_b: torch.Tensor,
    feature_blocks: Sequence[int] = DEFAULT_FEATURE_BLOCKS,
) -> torch.Tensor:
    """
    LPIPS-form distance per batch element: for each selected block, channel-unit-
    normalize activations, squared L2 over channels (weighted by the learned
    `lin{b}_w` vector when present — true LPIPS; uniform otherwise), mean over
    space, sum blocks.
    :param images_a, images_b: (B, 3, H, W) float in [-1, 1].
    :return: (B,) fp32 distances.
    """
    # vgg_features returns features in ASCENDING block order regardless of the
    # sequence order given; sort so lin{block}_w always pairs correctly.
    feature_blocks = tuple(sorted(feature_blocks))
    return feature_distance(params, vgg_features(params, images_a, feature_blocks),
                            vgg_features(params, images_b, feature_blocks), feature_blocks)


def feature_distance(
    params: VGGParams,
    feats_a: Sequence[torch.Tensor],
    feats_b: Sequence[torch.Tensor],
    feature_blocks: Sequence[int] = DEFAULT_FEATURE_BLOCKS,
) -> torch.Tensor:
    """The distance of `lpips_distance` from the two images' `vgg_features`
    (blocks in ascending order). :return: (B,) fp32 distances."""
    total = None
    for block, fa, fb in zip(sorted(feature_blocks), feats_a, feats_b):
        na = fa * torch.rsqrt(fa.square().sum(dim=1, keepdim=True) + 1e-10)
        nb = fb * torch.rsqrt(fb.square().sum(dim=1, keepdim=True) + 1e-10)
        sq = (na - nb).square()
        lin = params.get(f"lin{block}_w")
        if lin is not None:
            sq = sq * lin[None, :, None, None]
        d = sq.sum(dim=1).mean(dim=(1, 2))
        total = d if total is None else total + d
    return total


def downsample_to(images: torch.Tensor, size: int) -> torch.Tensor:
    """
    Average-pool square (B, C, H, W) images down to `size` (the projector
    evaluates LPIPS at 256px like the NVlabs implementation). No-op when
    already at or below size.
    """
    h = images.shape[2]
    if h <= size:
        return images
    factor = h // size
    return F.avg_pool2d(images, factor, factor)
