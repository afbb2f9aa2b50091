"""
Face + eye-landmark detection behind the reference's FaceFinderProxy API (the
port's copy of gance_tpu/overlay/faces.py, with cv2 imported where it is
used).

Detection runs on the native Viola-Jones detector (overlay/haar.py) with the
standard OpenCV cascade XMLs, looked up in `cv2.data.haarcascades` and then
`/usr/share/opencv4/haarcascades`. Landmarks are emitted in the
face_recognition dict shape ({'left_eye': [(x, y), ...], 'right_eye': [...]}).
Missing-eye handling is confidence-gated: one detected eye is mirrored across
the face midline; a face with NO detected eyes emits no landmarks, so the
phash/bbox overlay gate can never fire on fully fabricated boxes. The
geometric-prior fabrication is the opt-in `fabricate_missing_eyes` flag.
"""

import os
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from gance_tpu_torch.overlay import haar
from gance_tpu_torch.overlay.eye_refine import refine_eye_box
from gance_tpu_torch.types import BoundingBox, LabeledCoordinates


def cascade_dirs() -> List[Path]:
    """Where the cascade XMLs are looked for, in order: cv2's own data
    directory (some cv2 builds ship them), then the system's."""
    dirs = [Path("/usr/share/opencv4/haarcascades")]
    try:
        import cv2.data

        dirs.insert(0, Path(cv2.data.haarcascades))
    except (ImportError, AttributeError):
        pass
    return dirs


_FACE_CASCADE = "haarcascade_frontalface_default.xml"
_EYE_CASCADE = "haarcascade_eye.xml"


@lru_cache(maxsize=None)
def _cascade(name: str) -> haar.HaarCascade:
    dirs = cascade_dirs()
    for directory in dirs:
        path = directory / name
        if path.exists():
            return haar.parse_cascade_xml(str(path))
    raise FileNotFoundError(f"Haar cascade {name} not found in {dirs}")


def _median_box(boxes: List[BoundingBox]) -> Optional[BoundingBox]:
    """
    Element-wise median of overlapping candidate boxes — Viola-Jones emits a
    stack of near-duplicate detections at neighboring scales; the median is a
    stable consensus box (robust to the occasional oversized outlier).
    """
    if not boxes:
        return None
    return BoundingBox(
        x=int(np.median([b.x for b in boxes])),
        y=int(np.median([b.y for b in boxes])),
        width=int(np.median([b.width for b in boxes])),
        height=int(np.median([b.height for b in boxes])),
    )


def _eye_points(x: float, y: float, w: float, h: float) -> List[Tuple[int, int]]:
    """Six points outlining an eye box (face_recognition emits 6 per eye)."""
    return [
        (int(x), int(y + h / 2)),
        (int(x + w / 4), int(y)),
        (int(x + 3 * w / 4), int(y)),
        (int(x + w), int(y + h / 2)),
        (int(x + 3 * w / 4), int(y + h)),
        (int(x + w / 4), int(y + h)),
    ]


class FaceFinderProxy:
    """
    Lazy detector with the reference's proxy surface: `face_locations` (css-order
    boxes) and `face_landmarks` (eye keypoints). Lazy-loads cascades on first use
    (the reference's just-in-time loading).
    """

    def __init__(
        self,
        fabricate_missing_eyes: bool = False,
        refine_eye_centers: Optional[bool] = None,
    ) -> None:
        self._loaded = False
        self._face: Optional[haar.HaarCascade] = None
        self._eye: Optional[haar.HaarCascade] = None
        self.fabricate_missing_eyes = fabricate_missing_eyes
        # Landmark-grade precision: re-center each eye box on the
        # gradient-localized eye center (overlay/eye_refine.py). Defaults ON;
        # GANCE_TPU_EYE_REFINE=0 restores raw Haar geometry framework-wide.
        self.refine_eye_centers = (
            os.environ.get("GANCE_TPU_EYE_REFINE", "1") != "0"
            if refine_eye_centers is None
            else refine_eye_centers
        )

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._face = _cascade(_FACE_CASCADE)
            self._eye = _cascade(_EYE_CASCADE)
            self._loaded = True

    def _detect_faces(self, gray: np.ndarray) -> List[BoundingBox]:
        # sf=1.15/mn=4, as tuned in the JAX package on the reference's
        # face/no-face assets.
        min_size = max(24, int(min(gray.shape) * 0.1))
        return haar.detect(
            gray, self._face, scale_factor=1.15, min_neighbors=4, min_size=min_size,
            step=1,
        )

    def face_locations(self, face_image: np.ndarray) -> List[LabeledCoordinates]:
        """Faces as (top, right, bottom, left) — face_recognition's css order."""
        import cv2

        self._ensure_loaded()
        gray = cv2.cvtColor(np.asarray(face_image, np.uint8), cv2.COLOR_RGB2GRAY)
        return [
            LabeledCoordinates(
                top=b.y, right=b.x + b.width, bottom=b.y + b.height, left=b.x
            )
            for b in self._detect_faces(gray)
        ]

    def face_landmarks(
        self, face_image: np.ndarray
    ) -> List[Dict[str, List[Tuple[int, int]]]]:
        """Per-face eye keypoint dicts ({'left_eye': [...], 'right_eye': [...]})."""
        import cv2

        self._ensure_loaded()
        image = np.asarray(face_image, np.uint8)
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)

        results: List[Dict[str, List[Tuple[int, int]]]] = []
        for face in self._detect_faces(gray):
            fx, fy, fw, fh = face
            # Scan the whole face box for eye candidates, then filter
            # semantically: an eye is small relative to the face and its center
            # sits in the middle band of the box. (The haar face box often rides
            # high on real photos, so a fixed upper-fraction ROI truncates eyes —
            # measured on the reference's face assets.)
            roi = gray[fy : fy + fh, fx : fx + fw]
            candidates = (
                haar.detect(
                    roi, self._eye, scale_factor=1.05, min_neighbors=2,
                    min_size=max(8, fw // 10), step=1,
                )
                if roi.size
                else []
            )
            eyes = [
                e
                for e in candidates
                if e.height <= 0.35 * fh
                and 0.15 * fh <= e.y + e.height / 2 <= 0.75 * fh
            ]
            left = _median_box([e for e in eyes if e.x + e.width / 2 < fw / 2])
            right = _median_box([e for e in eyes if e.x + e.width / 2 >= fw / 2])

            if left is None and right is None:
                if not self.fabricate_missing_eyes:
                    # No real eye evidence: emit nothing so the overlay's
                    # phash/bbox gate cannot fire on fabricated boxes.
                    continue
                # opt-in geometric priors for low-texture/synthetic faces
                left = BoundingBox(
                    int(fw * 0.18), int(fh * 0.28), int(fw * 0.22), int(fh * 0.14)
                )
                right = BoundingBox(
                    int(fw * 0.60), int(fh * 0.28), int(fw * 0.22), int(fh * 0.14)
                )
            elif left is None:
                # mirror the detected right eye across the face midline —
                # anchored to a real detection, unlike a pure prior
                left = BoundingBox(
                    fw - (right.x + right.width), right.y, right.width, right.height
                )
            elif right is None:
                right = BoundingBox(
                    fw - (left.x + left.width), left.y, left.width, left.height
                )

            if self.refine_eye_centers:
                # Refinement reads the actual face pixels, so it runs on
                # mirrored (and opt-in fabricated) boxes too: when real eye
                # content sits near the placed box, the box locks onto it;
                # otherwise the shift guard keeps the geometric placement.
                left = refine_eye_box(roi, left)
                right = refine_eye_box(roi, right)

            results.append(
                {
                    "left_eye": _eye_points(
                        fx + left.x, fy + left.y, left.width, left.height
                    ),
                    "right_eye": _eye_points(
                        fx + right.x, fy + right.y, right.width, right.height
                    ),
                }
            )
        return results
