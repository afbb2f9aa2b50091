"""
Shape helpers and the named types of latent inputs, reducer outputs and images.

Shape taxonomy (V = latent length, usually 512; R = style rows, 18 at 1024px):
  SingleVector (V,), ConcatenatedVectors (N*V,), DividedVectors (N, V),
  SingleMatrix (R, V), ConcatenatedMatrices (R, N*V), DividedMatrices (N, R, V).
  Images are uint8 (H, W, 3), batches (B, H, W, 3).

The same names and fields as gance_tpu/types.py, so that values pass between
the two packages in tests.
"""

from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

RGBInt8Image = np.ndarray
ImageSourceType = Iterator[np.ndarray]


def is_vector(data) -> bool:
    """True when `data` is vector-shaped (ndim < 2)."""
    return np.ndim(data) < 2


def underlying_length(data) -> int:
    """Vector length of flat vector data, or row length of matrix data."""
    shape = np.shape(data)
    return int(shape[0] if len(shape) < 2 else shape[1])


class VectorsLabel(NamedTuple):
    """Flat vector data + its sub-vector length + a display label."""

    data: np.ndarray
    vector_length: int
    label: str


class MatricesLabel(NamedTuple):
    """Matrix data (R, N*V) + sub-vector length + a display label."""

    data: np.ndarray
    vector_length: int
    label: str


class LabeledCoordinates(NamedTuple):
    """A bounding box as (top, right, bottom, left)."""

    top: int
    right: int
    bottom: int
    left: int


class BoundingBox(NamedTuple):
    """A bounding box as (x, y, width, height)."""

    x: int
    y: int
    width: int
    height: int


class PathAndBoundingBoxes(NamedTuple):
    """A file path + the bounding boxes found within."""

    path_to_file: str
    bounding_boxes: Optional[Tuple[LabeledCoordinates, ...]]


class ImageResolution(NamedTuple):
    """(width, height) of an image."""

    width: int
    height: int


def image_resolution(image: np.ndarray) -> ImageResolution:
    """Resolution of an (H, W, C) image array."""
    return ImageResolution(width=int(image.shape[1]), height=int(image.shape[0]))


class DataLabel(NamedTuple):
    """A scalar-per-frame signal + label."""

    data: np.ndarray
    label: str


class ResultLayers(NamedTuple):
    """
    A reducer output: `result` is consumed downstream, `layers` record the
    provenance signals for debug visualization.
    """

    result: DataLabel
    layers: List[DataLabel]
