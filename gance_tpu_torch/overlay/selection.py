"""
Training-set curation: pick the best images from capture directories,
prioritizing faces (a copy of gance_tpu/overlay/selection.py on the port's
`overlay/faces.py` and `media/images.py`; reference
gance/select_good_face_images.py).

Priority fill order preserved: face images from primary directories → face images
from secondary directories → temporal neighbors (±2) of face images → random
remainder. Timestamp ordering comes from the Pi capture filename format
(reference gance/pi_images_common.py). PIL and cv2 are imported where an
image is read or scanned.
"""

import random
from datetime import datetime
from pathlib import Path
from typing import Iterable, List, NamedTuple, Optional, Sequence, Set

from gance_tpu_torch.types import PathAndBoundingBoxes
from gance_tpu_torch.utils.logging import LOGGER

IMAGE_TIMESTAMP_FORMAT = "%m-%d-%Y_%H-%M-%S-%f"
_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def create_image_filename(prefix: str, timestamp: Optional[datetime] = None) -> str:
    """Pi capture filename: {prefix}_{timestamp} (reference pi_images_common.py:12)."""
    timestamp = timestamp or datetime.now()
    return f"{prefix}_{timestamp.strftime(IMAGE_TIMESTAMP_FORMAT)}.jpeg"


def timestamp_from_filename(path: Path) -> Optional[datetime]:
    """Parse the capture timestamp out of a Pi filename; None when unparsable."""
    parts = path.stem.split("_")
    for start in range(len(parts)):
        candidate = "_".join(parts[start:])
        try:
            return datetime.strptime(candidate, IMAGE_TIMESTAMP_FORMAT)
        except ValueError:
            continue
    return None


def images_in_directory(directory: Path) -> List[Path]:
    """Images sorted by capture timestamp when possible, else by name."""
    paths = [
        p for p in Path(directory).iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES
    ]
    stamped = [(timestamp_from_filename(p), p) for p in paths]
    if all(ts is not None for ts, _ in stamped) and stamped:
        return [p for _, p in sorted(stamped, key=lambda tp: tp[0])]
    return sorted(paths)


def face_bounding_boxes(paths: Iterable[Path]) -> List[PathAndBoundingBoxes]:
    """Detect faces in each image (reference :22); deliberately sequential."""
    from gance_tpu_torch.media.images import read_image
    from gance_tpu_torch.overlay.faces import FaceFinderProxy

    finder = FaceFinderProxy()
    out: List[PathAndBoundingBoxes] = []
    for path in paths:
        try:
            locations = finder.face_locations(read_image(path))
        except Exception as e:  # broken image
            LOGGER.warning("Couldn't scan %s: %s", path, e)
            locations = []
        out.append(
            PathAndBoundingBoxes(
                path_to_file=str(path),
                bounding_boxes=tuple(locations) if locations else None,
            )
        )
    return out


class ImageSelectionOutput(NamedTuple):
    """Selected paths + accounting (reference :245)."""

    selected: List[Path]
    num_primary_faces: int
    num_secondary_faces: int
    num_neighbors: int
    num_random: int


def select_images_for_training(
    primary_directories: Sequence[Path],
    secondary_directories: Sequence[Path],
    num_images: Optional[int],
    neighbor_window: int = 2,
    seed: int = 1234,
) -> ImageSelectionOutput:
    """
    Priority fill to `num_images` (reference :256-352). `None` selects every
    image in every directory, matching the reference's `islice(..., None)`
    semantics for an omitted --target-num-images.
    """
    primary_images = [p for d in primary_directories for p in images_in_directory(d)]
    secondary_images = [p for d in secondary_directories for p in images_in_directory(d)]

    primary_scan = face_bounding_boxes(primary_images)
    secondary_scan = face_bounding_boxes(secondary_images)

    selected: List[Path] = []
    seen: Set[Path] = set()

    def take(paths: Iterable[Path]) -> int:
        count = 0
        for path in paths:
            if num_images is not None and len(selected) >= num_images:
                break
            path = Path(path)
            if path not in seen:
                seen.add(path)
                selected.append(path)
                count += 1
        return count

    primary_faces = [
        Path(s.path_to_file) for s in primary_scan if s.bounding_boxes
    ]
    secondary_faces = [
        Path(s.path_to_file) for s in secondary_scan if s.bounding_boxes
    ]
    n_primary = take(primary_faces)
    n_secondary = take(secondary_faces)

    # temporal neighbors (±window) of face images within the primary stream
    neighbors: List[Path] = []
    face_set = set(primary_faces)
    for index, path in enumerate(primary_images):
        if path in face_set:
            lo = max(0, index - neighbor_window)
            hi = min(len(primary_images), index + neighbor_window + 1)
            neighbors.extend(primary_images[lo:hi])
    n_neighbors = take(neighbors)

    remainder = [p for p in primary_images + secondary_images if p not in seen]
    random.Random(seed).shuffle(remainder)
    n_random = take(remainder)

    return ImageSelectionOutput(
        selected=selected,
        num_primary_faces=n_primary,
        num_secondary_faces=n_secondary,
        num_neighbors=n_neighbors,
        num_random=n_random,
    )
