"""
Gradient-based eye-center localization on top of the Haar eye boxes (the
port's copy of gance_tpu/overlay/eye_refine.py, with cv2 imported where it is
used).

Viola-Jones emits boxes whose position is quantized by the cascade's scale
pyramid and window stride. Within each detected eye box this module localizes
the eye center with the means-of-gradients objective of Timm & Barth (VISAPP
2011, "Accurate eye centre localisation by means of gradients") and
re-centers the box on it.

Method: for candidate center c, score(c) = w(c) * mean_i max(0, d_i . g_i)^2
over significant-gradient pixels i, where d_i is the unit displacement from c
to pixel i, g_i the unit image gradient, and w(c) a darkness prior (pupils are
dark). The maximum is taken over the pixels of a downscaled ROI (at most 32px
a side). Pure numpy.
"""

from typing import Optional, Tuple

import numpy as np

from gance_tpu_torch.types import BoundingBox

# Cap on the localization ROI side: 32px keeps the K^2 objective ~1M terms and
# is finer than the Haar pyramid's position quantization by an order of
# magnitude once mapped back to full resolution.
_MAX_SIDE = 32

# Gradient-magnitude significance gate (Timm-Barth's dynamic threshold shape):
# keep pixels with |g| > mean + 0.3 * std. Flat regions contribute noise only.
_GRAD_STD_FACTOR = 0.3

# Candidate centers are confined to a disk of this fraction of the box's longer
# side around the detector's center: Haar boxes are roughly eye-centered already
# (the needed correction is sub-window), and an unconstrained search latches
# onto eyebrows/shadows on a minority of frames.
_MAX_SHIFT_FRACTION = 0.25


def locate_eye_center(
    gray_roi: np.ndarray,
    center_prior: Optional[Tuple[float, float]] = None,
    max_shift: Optional[float] = None,
) -> Optional[Tuple[float, float]]:
    """
    The (x, y) of the eye center within ``gray_roi`` (float, ROI coordinates),
    or None when the ROI carries no usable gradient evidence (flat crop,
    degenerate shape). With ``center_prior``/``max_shift`` (ROI coordinates /
    pixels), the candidate search is confined to that disk — the caller's
    detector already localized the eye to a window, and the refinement's job is
    sub-window precision, not re-detection.
    """
    import cv2

    roi = np.asarray(gray_roi)
    if roi.ndim != 2 or min(roi.shape) < 4:
        return None
    roi = roi.astype(np.float32)

    h, w = roi.shape
    if max(h, w) > _MAX_SIDE:
        shrink = max(h, w) / float(_MAX_SIDE)
        small = cv2.resize(
            roi,
            (max(4, round(w / shrink)), max(4, round(h / shrink))),
            interpolation=cv2.INTER_AREA,
        )
    else:
        small = roi
    # Per-axis scales: the resize rounds (and floors at 4px) each axis
    # independently, so mapping back with one uniform factor would bias the
    # center by up to half a grid cell per axis on non-square ROIs — the same
    # magnitude as the precision this module exists to add.
    small_h, small_w = small.shape
    scale_x = w / float(small_w)
    scale_y = h / float(small_h)

    gy, gx = np.gradient(small)
    magnitude = np.hypot(gx, gy)
    threshold = float(magnitude.mean() + _GRAD_STD_FACTOR * magnitude.std())
    keep = magnitude > max(threshold, 1e-6)
    if not keep.any():
        return None

    ys, xs = np.nonzero(keep)
    g = np.stack([gx[keep], gy[keep]], axis=1) / magnitude[keep][:, None]  # (M, 2)
    p = np.stack([xs, ys], axis=1).astype(np.float32)  # (M, 2)

    cyy, cxx = np.mgrid[0:small_h, 0:small_w]
    centers = np.stack([cxx.ravel(), cyy.ravel()], axis=1).astype(np.float32)  # (K, 2)
    # full-resolution ROI coordinates of every candidate cell (pixel-center)
    full_x = (centers[:, 0] + 0.5) * scale_x - 0.5
    full_y = (centers[:, 1] + 0.5) * scale_y - 0.5
    # darkness prior: pupils are dark — weight by inverted smoothed intensity
    blurred = cv2.GaussianBlur(small, (5, 5), 0)
    weight = (255.0 - blurred).clip(min=0.0).ravel()

    if center_prior is not None and max_shift is not None:
        # Confine candidates BEFORE the O(K*M) objective: the disk holds a
        # small fraction of the grid, so filtering first is both the shift
        # guard and most of the module's compute budget.
        radius = max(float(max_shift), 1.0)
        in_disk = (full_x - center_prior[0]) ** 2 + (
            full_y - center_prior[1]
        ) ** 2 <= radius * radius
        if not in_disk.any():
            return None
        centers = centers[in_disk]
        full_x = full_x[in_disk]
        full_y = full_y[in_disk]
        weight = weight[in_disk]

    # d[k, m] = unit vector from candidate k to gradient pixel m
    d = p[None, :, :] - centers[:, None, :]  # (K, M, 2)
    norm = np.linalg.norm(d, axis=2)
    np.maximum(norm, 1e-6, out=norm)
    dots = (d[:, :, 0] * g[None, :, 0] + d[:, :, 1] * g[None, :, 1]) / norm
    np.maximum(dots, 0.0, out=dots)  # outward (dark->bright) alignment only
    score = np.square(dots).mean(axis=1) * weight  # (K,)

    best = int(np.argmax(score))
    if score[best] <= 0.0:
        return None
    return (float(full_x[best]), float(full_y[best]))


def refine_eye_box(
    gray: np.ndarray, box: BoundingBox, margin: float = 0.25
) -> BoundingBox:
    """
    Re-center ``box`` (in ``gray``'s coordinates) on the gradient-localized eye
    center, searched within ``_MAX_SHIFT_FRACTION`` of the box's longer side
    around the detection center. The box's size is the detector's business and
    is kept; only its position gains sub-window precision. Falls back to the
    input box when the localizer abstains — refinement can only relocate onto
    stronger evidence, never fabricate it.
    """
    h, w = gray.shape[:2]
    pad_x = int(round(box.width * margin))
    pad_y = int(round(box.height * margin))
    x0 = max(0, box.x - pad_x)
    y0 = max(0, box.y - pad_y)
    x1 = min(w, box.x + box.width + pad_x)
    y1 = min(h, box.y + box.height + pad_y)
    if x1 - x0 < 4 or y1 - y0 < 4:
        return box

    det_cx = box.x + box.width / 2.0
    det_cy = box.y + box.height / 2.0
    center = locate_eye_center(
        gray[y0:y1, x0:x1],
        center_prior=(det_cx - x0, det_cy - y0),
        max_shift=_MAX_SHIFT_FRACTION * max(box.width, box.height),
    )
    if center is None:
        return box
    cx, cy = center[0] + x0, center[1] + y0

    new_x = int(round(cx - box.width / 2.0))
    new_y = int(round(cy - box.height / 2.0))
    # keep the re-centered box inside the image so downstream crops stay valid
    new_x = int(np.clip(new_x, 0, max(0, w - box.width)))
    new_y = int(np.clip(new_y, 0, max(0, h - box.height)))
    return BoundingBox(x=new_x, y=new_y, width=box.width, height=box.height)
