"""
Still-image IO and compositing helpers (the counterpart of
gance_tpu/media/images.py). PIL and cv2 are imported inside the functions
that use them, so the module imports on a host that has neither.
"""

from pathlib import Path
from typing import Iterable

import numpy as np

PNG = "png"


def read_image(image_path: Path) -> np.ndarray:
    """Read an image file to an RGB uint8 array."""
    from PIL import Image

    with Image.open(str(image_path)) as img:
        return np.asarray(img.convert("RGB"))


def write_image(image: np.ndarray, path: Path) -> None:
    """Write an RGB uint8 array as PNG/JPEG by extension."""
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.asarray(image, np.uint8)).save(str(path))


def horizontal_concat_images(images: Iterable[np.ndarray]) -> np.ndarray:
    """hconcat a list of same-height images."""
    import cv2

    images = list(images)
    if not images:
        raise ValueError("No images to concatenate")
    return cv2.hconcat([np.asarray(i, np.uint8) for i in images])
