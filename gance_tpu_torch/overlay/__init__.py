"""
The port's face/eye overlay: find eyes in the projection-target (foreground)
and synthesized (background) frames, gate on bbox distance + perceptual-hash
similarity of the eye crops, and composite the foreground eye regions over the
background (the counterpart of gance_tpu/overlay/).

Detection runs on the native Viola-Jones detector (`overlay/haar.py`, built
with g++ at first use) with OpenCV's cascade XMLs; the pHash's DCT runs on the
device. cv2 is imported only where it is used.
"""

from gance_tpu_torch.overlay.common import (
    BoundingBox,
    OverlayResult,
    bounding_box_distance,
    landmarks_to_bounding_boxes,
    write_boxes_onto_image,
)
from gance_tpu_torch.overlay.eye_tracking import OverlayContext, compute_eye_tracking_overlay
from gance_tpu_torch.overlay.phash import phash, phash_distance

__all__ = [
    "BoundingBox",
    "OverlayResult",
    "OverlayContext",
    "bounding_box_distance",
    "landmarks_to_bounding_boxes",
    "write_boxes_onto_image",
    "compute_eye_tracking_overlay",
    "phash",
    "phash_distance",
]
