"""
Haar cascade XML parsing + the port's own ctypes binding of the native
Viola-Jones detector (`native/haar_detector.cpp` at the root of the
repository).

The shared library is built at first use with
`g++ -O2 -Wall -Wextra -fPIC -shared -std=c++17` from that source into
`build/` beside this file (listed in .gitignore); its name carries a hash of
the source and the flags, so a changed source builds anew. Only g++ is
needed: no make.

Parses OpenCV's new-format cascade XMLs (the standard haarcascade_*.xml files
that ship with OpenCV) into flat arrays consumed by the C++ core. Tilted
features are rejected (none of the face/eye cascades used here contain them).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import List, Optional

import numpy as np

from gance_tpu_torch.types import BoundingBox
from gance_tpu_torch.utils.logging import LOGGER

SOURCE = Path(__file__).resolve().parents[2] / "native" / "haar_detector.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O2", "-Wall", "-Wextra", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
# Detection runs from a thread pool (eye_tracking), so the lazy build and load
# are serialized: two threads racing the build onto one .so corrupt it.
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgance_vision-{digest}.so"


def build_library() -> Path:
    """Compile the detector if its library is missing; returns the library's path."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    LOGGER.info("Building the native Haar detector into %s", target)
    result = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{result.stderr}")
    os.replace(tmp, target)  # atomic: another process never loads half a file
    return target


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:  # lost the race to another thread: already loaded
            return _lib
        return _load_library_locked()


def _load_library_locked() -> ctypes.CDLL:
    global _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.haar_detect.restype = ctypes.c_int
    lib.haar_detect.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    _lib = lib
    return lib


@dataclass
class HaarCascade:
    """Flat-array form of an OpenCV cascade."""

    window_w: int
    window_h: int
    stage_thresholds: np.ndarray  # float32 (n_stages,)
    stage_offsets: np.ndarray  # int32 (n_stages+1,)
    node_feature: np.ndarray  # int32 (n_weak,)
    node_threshold: np.ndarray  # float32 (n_weak,)
    leaf_values: np.ndarray  # float32 (n_weak, 2)
    feature_offsets: np.ndarray  # int32 (n_features+1,)
    rects: np.ndarray  # float32 (n_rects, 5)


@lru_cache(maxsize=None)
def parse_cascade_xml(path: str) -> HaarCascade:
    """Parse a new-format OpenCV Haar cascade XML into flat arrays."""
    root = ET.parse(str(path)).getroot()
    cascade = root.find("cascade")
    if cascade is None:
        raise ValueError(f"{path} is not a new-format OpenCV cascade")
    if cascade.findtext("featureType", "HAAR").strip() != "HAAR":
        raise ValueError("Only HAAR feature cascades are supported")

    window_w = int(cascade.findtext("width"))
    window_h = int(cascade.findtext("height"))

    stage_thresholds: List[float] = []
    stage_offsets: List[int] = [0]
    node_feature: List[int] = []
    node_threshold: List[float] = []
    leaf_values: List[List[float]] = []

    for stage in cascade.find("stages"):
        stage_thresholds.append(float(stage.findtext("stageThreshold")))
        for weak in stage.find("weakClassifiers"):
            internal = [float(v) for v in weak.findtext("internalNodes").split()]
            leaves = [float(v) for v in weak.findtext("leafValues").split()]
            if len(internal) != 4 or len(leaves) != 2:
                raise ValueError("Only stump-based cascades are supported")
            # internalNodes: left_child right_child feature_idx threshold
            node_feature.append(int(internal[2]))
            node_threshold.append(internal[3])
            leaf_values.append(leaves)
        stage_offsets.append(len(node_feature))

    feature_offsets: List[int] = [0]
    rects: List[List[float]] = []
    for feature in cascade.find("features"):
        tilted = feature.findtext("tilted")
        if tilted is not None and int(tilted.strip()):
            raise ValueError("Tilted Haar features are not supported")
        for rect in feature.find("rects"):
            vals = [float(v) for v in rect.text.split()]
            rects.append(vals)  # x y w h weight
        feature_offsets.append(len(rects))

    return HaarCascade(
        window_w=window_w,
        window_h=window_h,
        stage_thresholds=np.asarray(stage_thresholds, np.float32),
        stage_offsets=np.asarray(stage_offsets, np.int32),
        node_feature=np.asarray(node_feature, np.int32),
        node_threshold=np.asarray(node_threshold, np.float32),
        leaf_values=np.asarray(leaf_values, np.float32),
        feature_offsets=np.asarray(feature_offsets, np.int32),
        rects=np.asarray(rects, np.float32),
    )


def detect(
    gray: np.ndarray,
    cascade: HaarCascade,
    scale_factor: float = 1.1,
    min_neighbors: int = 3,
    min_size: int = 0,
    step: int = 2,
    max_detections: int = 256,
) -> List[BoundingBox]:
    """Run the native detector over a uint8 grayscale image."""
    lib = _load_library()
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape
    out = np.zeros((max_detections, 4), np.float32)

    def fptr(a: np.ndarray, ctype):
        return np.ascontiguousarray(a).ctypes.data_as(ctypes.POINTER(ctype))

    n = lib.haar_detect(
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        cascade.window_w, cascade.window_h,
        len(cascade.stage_thresholds), len(cascade.node_feature),
        len(cascade.feature_offsets) - 1, len(cascade.rects),
        fptr(cascade.stage_thresholds, ctypes.c_float),
        fptr(cascade.stage_offsets, ctypes.c_int32),
        fptr(cascade.node_feature, ctypes.c_int32),
        fptr(cascade.node_threshold, ctypes.c_float),
        fptr(cascade.leaf_values, ctypes.c_float),
        fptr(cascade.feature_offsets, ctypes.c_int32),
        fptr(cascade.rects, ctypes.c_float),
        float(scale_factor), int(min_neighbors), int(min_size), int(step),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_detections,
    )
    return [
        BoundingBox(x=int(row[0]), y=int(row[1]), width=int(row[2]), height=int(row[3]))
        for row in out[:n]
    ]
