"""
Dataset/workspace path configuration (a copy of gance_tpu/utils/paths.py): the
roles of the training-set curation flow, configurable by environment variables
with defaults relative to the working directory.
"""

import os
from pathlib import Path

# Root for curated training datasets.
DATASET_ROOT = Path(os.environ.get("GANCE_TPU_DATASET_ROOT", "./datasets"))

# Incoming capture drop directory.
CAPTURE_DROP_DIRECTORY = Path(
    os.environ.get("GANCE_TPU_CAPTURE_DROP", str(DATASET_ROOT / "incoming"))
)

# Where curated "good face" selections are copied (select-images-copy default).
GOOD_IMAGES_DIRECTORY = Path(
    os.environ.get("GANCE_TPU_GOOD_IMAGES", str(DATASET_ROOT / "good_images"))
)
