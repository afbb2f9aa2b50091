"""
Eye-tracking overlay gating (the port's copy of gance_tpu/overlay/
eye_tracking.py, over the port's pHash, whose DCT runs on `device`, and its
face finder).

Per frame pair (foreground = projection target, background = synthesized): find eye
boxes in both; overlay iff the closest pair of eye boxes is nearer than
`min_bbox_distance` AND the perceptual-hash distance of the two eye *crops* is at
most `min_phash_distance` (the bbox-crop phash per CHANGELOG 0.19.0). Honors the
per-frame `skip_mask`.
"""

import collections
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from gance_tpu_torch.overlay.common import (
    BoundingBox,
    DistanceBoxes,
    OverlayResult,
    bounding_box_distance,
    convert_to_pil_box,
    landmarks_to_bounding_boxes,
)
from gance_tpu_torch.overlay.faces import FaceFinderProxy
from gance_tpu_torch.overlay.phash import phash_batch, phash_distance
from gance_tpu_torch.types import ImageSourceType
from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER


class OverlayContext(NamedTuple):
    """Why a frame was or wasn't overlaid."""

    overlay_written: bool = False
    bbox_distance: Optional[float] = None
    bbox_perceptual_hash_distance: Optional[int] = None


class _FrameOverlayResult(NamedTuple):
    foreground_bounding_boxes: Optional[List[BoundingBox]] = None
    context: OverlayContext = OverlayContext()


class _DetectionRecord(NamedTuple):
    """Per-frame raw detection outputs (the parallel stage's product); the
    gating decision is applied sequentially so temporal smoothing can carry
    state across frames."""

    skip: bool = False
    foreground_boxes: List[BoundingBox] = []
    distance_boxes: Optional[DistanceBoxes] = None
    bbox_phash_distance: Optional[int] = None


def _box_center(box: BoundingBox) -> Tuple[float, float]:
    return (box.x + box.width / 2.0, box.y + box.height / 2.0)


def _center_distance(a: BoundingBox, b: BoundingBox) -> float:
    (ax, ay), (bx, by) = _box_center(a), _box_center(b)
    return float(np.hypot(ax - bx, ay - by))


def _mean_box(history: "collections.deque") -> BoundingBox:
    arr = np.asarray([tuple(box) for box in history], dtype=np.float64)
    x, y, w, h = arr.mean(axis=0)
    return BoundingBox(int(round(x)), int(round(y)), int(round(w)), int(round(h)))


def _decide(
    record: _DetectionRecord,
    min_phash_distance: int,
    min_bbox_distance: float,
    pair: Optional[Tuple[BoundingBox, BoundingBox]] = None,
) -> _FrameOverlayResult:
    """The gating rule over a frame's (possibly smoothed) box pair: overlay iff
    the pair's center distance < min_bbox_distance AND the eye-crop phash
    distance <= min_phash_distance (the reference's gate)."""
    if record.skip or record.distance_boxes is None:
        return _FrameOverlayResult(
            context=OverlayContext(
                bbox_distance=(
                    record.distance_boxes.distance if record.distance_boxes else None
                ),
                bbox_perceptual_hash_distance=record.bbox_phash_distance,
            )
        )
    a_box, b_box = pair if pair is not None else (
        record.distance_boxes.a_box, record.distance_boxes.b_box,
    )
    distance = _center_distance(a_box, b_box)
    box_flag = distance < min_bbox_distance
    overlay_flag = (
        box_flag
        and record.bbox_phash_distance is not None
        and record.bbox_phash_distance <= min_phash_distance
    )
    drawn = record.foreground_boxes
    if overlay_flag and pair is not None:
        # draw the SMOOTHED box for the matched face (the stabilization the
        # smoothing exists for); other detected faces keep their raw boxes
        drawn = [
            a_box if box == record.distance_boxes.a_box else box
            for box in record.foreground_boxes
        ]
    return _FrameOverlayResult(
        foreground_bounding_boxes=drawn if overlay_flag else None,
        context=OverlayContext(
            bbox_perceptual_hash_distance=record.bbox_phash_distance,
            bbox_distance=distance,
            overlay_written=overlay_flag,
        ),
    )


def _smoothed_decisions(
    records: Iterable[_DetectionRecord],
    window: int,
    min_phash_distance: int,
    min_bbox_distance: float,
) -> Iterator[_FrameOverlayResult]:
    """
    Sequential temporal smoothing of the matched eye-box pair: each side's
    (x, y, w, h) is averaged over a trailing `window` of frames before the
    distance gate runs, which suppresses single-frame detector jitter (box
    instability the reference's track-length filter cannot catch — it filters
    decision flips after the fact, not geometry). The history RESETS on
    skip/no-detection frames and on center jumps larger than twice the box
    size (scene cuts must not smear across shots). pHash gating uses the RAW
    detected crops — smoothing stabilizes geometry, not content identity.
    """
    history_a: "collections.deque" = collections.deque(maxlen=window)
    history_b: "collections.deque" = collections.deque(maxlen=window)
    for record in records:
        if record.skip or record.distance_boxes is None:
            history_a.clear()
            history_b.clear()
            yield _decide(record, min_phash_distance, min_bbox_distance)
            continue
        raw_a, raw_b = record.distance_boxes.a_box, record.distance_boxes.b_box
        if history_a:
            jump_limit = 2.0 * max(raw_a.width, raw_a.height, 1)
            if _center_distance(raw_a, history_a[-1]) > jump_limit:
                history_a.clear()
                history_b.clear()
        history_a.append(raw_a)
        history_b.append(raw_b)
        yield _decide(
            record,
            min_phash_distance,
            min_bbox_distance,
            pair=(_mean_box(history_a), _mean_box(history_b)),
        )


def _crop(image: np.ndarray, box: BoundingBox) -> np.ndarray:
    """
    Crop with PIL semantics: the output is always exactly box-sized, with regions
    outside the image filled with black (PIL.Image.crop pads; plain slicing would
    clamp and change the pHash of edge-of-frame eye boxes).
    """
    left, upper, right, lower = convert_to_pil_box(box)
    h, w = image.shape[:2]
    out = np.zeros((box.height, box.width) + image.shape[2:], dtype=image.dtype)
    src_y0, src_y1 = max(upper, 0), min(lower, h)
    src_x0, src_x1 = max(left, 0), min(right, w)
    if src_y1 > src_y0 and src_x1 > src_x0:
        out[src_y0 - upper : src_y1 - upper, src_x0 - left : src_x1 - left] = image[
            src_y0:src_y1, src_x0:src_x1
        ]
    return out


def _landmarks_at_detection_side(
    face_finder: FaceFinderProxy,
    image: np.ndarray,
    detection_side: Optional[int],
) -> List[dict]:
    """
    Eye landmarks in FULL-RESOLUTION coordinates, optionally detected on a
    downscaled copy. `detection_side` bounds the longer image side during
    detection only — the Viola-Jones pyramid cost scales with frame area, and
    the faces this pipeline tracks are large relative to the frame, so
    detecting at e.g. 512px and scaling the points back loses little accuracy
    while cutting the host-side overlay cost ~quadratically. None (the
    default) detects at full resolution, byte-for-byte the previous behavior.
    Downstream gating (bbox distance in pixels, phash of the eye crops) always
    runs at full resolution either way, so the thresholds keep their meaning.
    """
    h, w = image.shape[:2]
    if detection_side is None or max(h, w) <= detection_side:
        return face_finder.face_landmarks(face_image=image)

    import cv2

    scale = detection_side / max(h, w)
    small = cv2.resize(
        image, (max(1, round(w * scale)), max(1, round(h * scale))),
        interpolation=cv2.INTER_AREA,
    )
    fx = w / small.shape[1]
    fy = h / small.shape[0]
    scaled: List[dict] = []
    for landmark_dict in face_finder.face_landmarks(face_image=small):
        scaled.append(
            {
                eye: [(round(x * fx), round(y * fy)) for x, y in points]
                for eye, points in landmark_dict.items()
            }
        )
    return scaled


def _bounded_ordered_map(
    fn: Callable, items: Iterable, workers: int
) -> Iterator:
    """
    map() with a worker pool, preserving BOTH the input order and the lazy
    constant-memory streaming property: at most ~2*workers items are in flight,
    results yield in submission order. Frames are independent, and the native
    detector releases the GIL inside its ctypes call, so detection scales
    ~linearly with host cores; workers<=1 degrades to plain map.
    """
    if workers <= 1:
        yield from map(fn, items)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: "collections.deque" = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def compute_eye_tracking_overlay(
    foreground_images: ImageSourceType,
    background_images: ImageSourceType,
    min_phash_distance: int,
    min_bbox_distance: float,
    skip_mask: Optional[List[bool]] = None,
    detection_side: Optional[int] = None,
    detection_workers: Optional[int] = None,
    temporal_smoothing: int = 0,
    want_contexts: bool = True,
    device: Device = "cuda",
) -> OverlayResult:
    """
    Lazily compute per-frame overlay decisions; returns the two decision streams
    (bbox lists to composite, contexts for visualization).

    :param detection_side: optional cap on the longer frame side during eye
        DETECTION (see _landmarks_at_detection_side); gating still runs at
        full resolution. None = detect at full resolution.
    :param detection_workers: worker threads for the per-frame detection
        (results stay frame-ordered and bit-identical; the detector releases
        the GIL). None = one per host core.
    :param temporal_smoothing: when > 1, average the matched eye-box pair's
        geometry over this many trailing frames before the distance gate and
        composite (see _smoothed_decisions). 0/1 = off, the reference's exact
        per-frame behavior. With smoothing on, the eye-crop pHash is computed
        for EVERY detected pair (the raw distance no longer decides alone), a
        small extra cost per detected frame.
    :param device: where the eye crops' pHash DCT runs ("cuda" by default;
        raises on a host without CUDA).
    """
    device = resolve_device(device)
    face_finder = FaceFinderProxy()
    # Default capped at 8: the in-flight buffer is 2*workers full-res frame
    # PAIRS (a 64-core default would pin ~3.6GB at 2160px), and beyond ~8
    # workers the GIL-bound share (cvtColor, numpy, phash) saturates anyway.
    # Floor of 2 even on a 1-core host: pulling the next frame pair blocks on
    # device fetch / disk with the GIL released, and the native detector also
    # releases it — so one worker detecting while the pool feeder pulls the
    # next pair overlaps detection with synthesis egress instead of
    # serializing them.
    workers = (
        detection_workers
        if detection_workers is not None
        else max(2, min(os.cpu_count() or 1, 8))
    )
    smoothing = temporal_smoothing if temporal_smoothing and temporal_smoothing > 1 else 0

    def per_frame(
        packed: Tuple[int, np.ndarray, np.ndarray, bool]
    ) -> _DetectionRecord:
        frame_number, foreground_image, background_image, skip = packed

        if skip:
            LOGGER.info("Skipping eye tracking overlay for frame #%d", frame_number)
            return _DetectionRecord(skip=True)

        foreground_boxes = landmarks_to_bounding_boxes(
            _landmarks_at_detection_side(
                face_finder, foreground_image, detection_side
            )
        )
        background_boxes = landmarks_to_bounding_boxes(
            _landmarks_at_detection_side(
                face_finder, background_image, detection_side
            )
        )

        distance_boxes: Optional[DistanceBoxes] = bounding_box_distance(
            a_boxes=foreground_boxes, b_boxes=background_boxes
        )

        # pHash of the RAW matched crops. Without smoothing it is computed
        # lazily — only when the raw distance gate passes (the reference's
        # behavior); with smoothing the gate distance is decided later, so
        # every detected pair is hashed.
        bbox_phash_dist: Optional[int] = None
        if distance_boxes is not None and (
            smoothing or distance_boxes.distance < min_bbox_distance
        ):
            fg_crop = _crop(foreground_image, distance_boxes.a_box)
            bg_crop = _crop(background_image, distance_boxes.b_box)
            if fg_crop.size and bg_crop.size:
                hashes = phash_batch([fg_crop, bg_crop], device=device)
                bbox_phash_dist = phash_distance(hashes[0], hashes[1])

        LOGGER.info("Computed eye tracking detection for frame #%d", frame_number)
        return _DetectionRecord(
            skip=False,
            foreground_boxes=foreground_boxes,
            distance_boxes=distance_boxes,
            bbox_phash_distance=bbox_phash_dist,
        )

    records: Iterator[_DetectionRecord] = _bounded_ordered_map(
        per_frame,
        zip(
            itertools.count(),
            foreground_images,
            background_images,
            skip_mask if skip_mask is not None else itertools.cycle([False]),
        ),
        workers=workers,
    )

    if smoothing:
        results: Iterator[_FrameOverlayResult] = _smoothed_decisions(
            records, smoothing, min_phash_distance, min_bbox_distance
        )
    else:
        results = (
            _decide(record, min_phash_distance, min_bbox_distance)
            for record in records
        )

    if not want_contexts:
        # No tee: a consumer that never drains `contexts` would otherwise
        # leave the tee buffering one _FrameOverlayResult per frame for the
        # whole run (O(frames) host memory on album-length renders).
        return OverlayResult(
            bbox_lists=(r.foreground_bounding_boxes for r in results),
            contexts=iter(()),
        )
    # Split the per-frame tuples into two lockstep streams without materializing.
    primary, secondary = itertools.tee(results, 2)
    return OverlayResult(
        bbox_lists=(r.foreground_bounding_boxes for r in primary),
        contexts=(r.context for r in secondary),
    )
