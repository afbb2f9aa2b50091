"""
Bounding-box math + mask compositing (the port's copy of
gance_tpu/overlay/common.py, with cv2 imported where it is used). Semantics
kept: eye-landmark bounding rects (cv2.boundingRect, inclusive plus 1), min
center-distance pairing, the 5.8%/9.8%-of-resolution mask pads,
PIL-composite equivalence (done in numpy).
"""

import itertools
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from gance_tpu_torch.types import BoundingBox, ImageResolution, image_resolution


def convert_to_pil_box(bounding_box: BoundingBox) -> Tuple[int, int, int, int]:
    """(x, y, w, h) -> PIL crop order (left, upper, right, lower)."""
    return (
        bounding_box.x,
        bounding_box.y,
        bounding_box.x + bounding_box.width,
        bounding_box.y + bounding_box.height,
    )


def landmarks_to_bounding_boxes(
    landmarks: List[Dict[str, List[Tuple[int, int]]]]
) -> List[BoundingBox]:
    """Bounding rect over each face's left+right eye keypoints."""
    import cv2

    return [
        BoundingBox(*cv2.boundingRect(np.array(lm["left_eye"] + lm["right_eye"])))
        for lm in landmarks
    ]


def bounding_box_center(bounding_box: BoundingBox) -> Tuple[float, float]:
    return (
        bounding_box.x + bounding_box.width / 2,
        bounding_box.y + bounding_box.height / 2,
    )


class DistanceBoxes(NamedTuple):
    """Min-distance box pair + the distance in pixels."""

    distance: float
    a_box: BoundingBox
    b_box: BoundingBox


def bounding_box_distance(
    a_boxes: List[BoundingBox], b_boxes: List[BoundingBox]
) -> Optional[DistanceBoxes]:
    """Minimum euclidean center distance across the cartesian product."""
    candidates = [
        DistanceBoxes(
            distance=float(
                np.hypot(
                    *(np.subtract(bounding_box_center(a), bounding_box_center(b)))
                )
            ),
            a_box=a,
            b_box=b,
        )
        for a, b in itertools.product(a_boxes, b_boxes)
    ]
    return min(candidates, key=lambda db: db.distance, default=None)


def draw_mask(resolution: ImageResolution, bounding_boxes: List[BoundingBox]) -> np.ndarray:
    """
    White rectangles (uint8 0/255 mask) around each box, padded by the reference's
    magic fractions: y_pad = width*0.058, x_pad = height*0.098 (the axes really
    are crossed like that in the reference).
    """
    import cv2

    mask = np.zeros((resolution.height, resolution.width), np.uint8)
    for box in bounding_boxes:
        x, y, w, h = box
        y_pad = resolution.width * 0.058
        x_pad = resolution.height * 0.098
        y_center = y + h / 2
        y_lower = int(round(y_center + y_pad))
        y_upper = int(round(y_center - y_pad))
        x_left = int(round(x - x_pad))
        x_right = int(round(x + w + x_pad))
        cv2.rectangle(mask, (x_left, y_upper), (x_right, y_lower), color=255, thickness=-1)
    return mask


def write_boxes_onto_image(
    foreground_image: np.ndarray,
    background_image: np.ndarray,
    bounding_boxes: List[BoundingBox],
) -> np.ndarray:
    """Composite padded foreground regions over the background."""
    mask = draw_mask(image_resolution(foreground_image), bounding_boxes)
    out = np.where(
        mask[..., None] > 0,
        np.asarray(foreground_image, np.uint8),
        np.asarray(background_image, np.uint8),
    )
    return out


class OverlayResult(NamedTuple):
    """Streams of per-frame overlay decisions."""

    bbox_lists: Iterator[Optional[List[BoundingBox]]]
    contexts: Iterator["OverlayContext"]  # noqa: F821 - defined in eye_tracking
