"""
Perceptual hash (pHash) of a batch of crops, with the DCT on the device (the
counterpart of gance_tpu/overlay/phash.py).

imagehash.phash semantics, the overlay's gating metric: grayscale -> 32x32
(host, cv2 INTER_AREA) -> 2-D DCT-II -> top-left 8x8 coefficients -> median
threshold -> 64-bit hash; distance = Hamming.

The DCT keeps only rows 0-7 of the unnormalised DCT-II matrix
C[k, n] = 2 cos(pi k (2n+1) / 64) (`jax.scipy.fft.dct`'s default norm), so
the 8x8 corner is C8 @ X @ C8.T. The two products are broadcast multiplies
and sums in float32, not matmuls: a matmul under TF32 (a process-wide flag)
moves the coefficients by about 1e-3 relative and flips bits near the
median, and detection calls this from worker threads, where toggling that
flag would race. Each call builds its own tensors; nothing is shared.
"""

import math
from typing import List

import numpy as np
import torch

from gance_tpu_torch.utils.device import Device, resolve_device

HASH_SIZE = 8
HIGHFREQ_FACTOR = 4
_RESIZE = HASH_SIZE * HIGHFREQ_FACTOR  # 32


def _prepare_crop(image: np.ndarray) -> np.ndarray:
    """RGB (or gray) uint8 crop -> 32x32 float grayscale (PIL 'L' weights)."""
    import cv2

    image = np.asarray(image)
    if image.ndim == 3:
        # PIL convert('L') weights
        gray = (
            image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114
        ).astype(np.float32)
    else:
        gray = image.astype(np.float32)
    return cv2.resize(gray, (_RESIZE, _RESIZE), interpolation=cv2.INTER_AREA)


def dct_rows() -> np.ndarray:
    """Rows 0..7 of the unnormalised 32-point DCT-II matrix, float32 (8, 32)."""
    k = np.arange(HASH_SIZE, dtype=np.float64)[:, None]
    n = np.arange(_RESIZE, dtype=np.float64)[None, :]
    return (2.0 * np.cos(math.pi * k * (2.0 * n + 1.0) / (2.0 * _RESIZE))).astype(np.float32)


def low_frequencies(batch: torch.Tensor) -> torch.Tensor:
    """(B, 32, 32) float32 -> (B, 64) float32: the 8x8 corner of the 2-D DCT-II,
    first along axis 1 and then axis 2, as `jax.scipy.fft.dct` is applied."""
    c8 = torch.from_numpy(dct_rows()).to(batch.device)
    # Y[b, k, m] = sum_n C8[k, n] X[b, n, m]
    y = (c8[None, :, :, None] * batch[:, None, :, :]).sum(dim=2)
    # Z[b, k, l] = sum_m Y[b, k, m] C8[l, m]
    z = (y[:, :, None, :] * c8[None, None, :, :]).sum(dim=3)
    return z.reshape(batch.shape[0], HASH_SIZE * HASH_SIZE)


def bits_from_low_frequencies(low: torch.Tensor) -> torch.Tensor:
    """(B, 64) -> (B, 64) bool: each coefficient above the row's median, the
    median being the mean of the two middle values as `jnp.median` takes it
    (`torch.median` would return the lower one)."""
    ordered = torch.sort(low, dim=1).values
    half = low.shape[1] // 2
    median = (ordered[:, half - 1] + ordered[:, half]) * 0.5
    return low > median[:, None]


def phash_batch(crops: List[np.ndarray], device: Device = "cuda") -> np.ndarray:
    """Hash a list of uint8 crops (any sizes) -> (B, 64) bool array; the DCT
    and the threshold run on `device`."""
    device = resolve_device(device)
    prepared = np.stack([_prepare_crop(c) for c in crops])
    batch = torch.from_numpy(prepared).to(device)
    return bits_from_low_frequencies(low_frequencies(batch)).cpu().numpy()


def phash(image: np.ndarray, device: Device = "cuda") -> np.ndarray:
    """Hash one crop -> (64,) bool array."""
    return phash_batch([image], device=device)[0]


def phash_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Hamming distance between two hash bit arrays."""
    return int(np.count_nonzero(np.asarray(a) != np.asarray(b)))
