"""
Shape helpers for latent inputs.

Shape taxonomy (V = latent length, usually 512; R = style rows, 18 at 1024px):
  SingleVector (V,), DividedVectors (N, V), SingleMatrix (R, V),
  DividedMatrices (N, R, V). Images are uint8 (H, W, 3), batches (B, H, W, 3).
"""

import numpy as np


def is_vector(data) -> bool:
    """True when `data` is vector-shaped (ndim < 2)."""
    return np.ndim(data) < 2
