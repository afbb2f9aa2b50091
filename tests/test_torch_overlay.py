"""
The port's overlay (gance_tpu_torch.overlay) against gance_tpu's, on the CPU:
the pHash bits (the port's DCT as two float32 products against JAX's FFT DCT
and a numpy derivation), its median on ties, box geometry and compositing,
the native Haar detector through each package's own binding, and the
eye-tracking decisions with a shared deterministic fake landmark finder.
"""

import hashlib
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402
import scipy.fftpack  # noqa: E402

from gance_tpu.overlay import common as jax_common  # noqa: E402
from gance_tpu.overlay import eye_tracking as jax_tracking  # noqa: E402
from gance_tpu.overlay import faces as jax_faces  # noqa: E402
from gance_tpu.overlay import haar as jax_haar  # noqa: E402
from gance_tpu.types import BoundingBox as JaxBox  # noqa: E402
from gance_tpu.types import ImageResolution as JaxResolution  # noqa: E402
from gance_tpu_torch.overlay import common as port_common  # noqa: E402
from gance_tpu_torch.overlay import eye_tracking as port_tracking  # noqa: E402
from gance_tpu_torch.overlay import faces as port_faces  # noqa: E402
from gance_tpu_torch.overlay import haar as port_haar  # noqa: E402
from gance_tpu_torch.types import BoundingBox, ImageResolution  # noqa: E402

# the packages export a function named phash, which hides the module
jax_phash = importlib.import_module("gance_tpu.overlay.phash")
port_phash = importlib.import_module("gance_tpu_torch.overlay.phash")


def seeded_crops(seed: int, count: int):
    rng = np.random.RandomState(seed)
    crops = []
    for _ in range(count):
        h, w = rng.randint(8, 121, size=2)
        crops.append((rng.rand(h, w, 3) * 255).astype(np.uint8))
    return crops


def numpy_low_frequencies(crop: np.ndarray) -> np.ndarray:
    """tests/test_overlay.py's derivation, in float64 after the resize."""
    gray = (crop[..., 0] * 0.299 + crop[..., 1] * 0.587 + crop[..., 2] * 0.114).astype(
        np.float32)
    resized = cv2.resize(gray, (32, 32), interpolation=cv2.INTER_AREA).astype(np.float64)
    return scipy.fftpack.dct(scipy.fftpack.dct(resized, axis=0), axis=1)[:8, :8].ravel()


def test_phash_bits_match_jax_and_numpy():
    """64 crops of 8-120 px: the port's bits equal JAX's and the numpy
    derivation's on every crop."""
    crops = seeded_crops(7, 64)
    port = port_phash.phash_batch(crops, device="cpu")
    jax = jax_phash.phash_batch(crops)
    assert port.shape == (64, 64) and port.dtype == bool
    np.testing.assert_array_equal(port, jax)
    for crop, got in zip(crops, port):
        low = numpy_low_frequencies(crop)
        np.testing.assert_array_equal(got, low > np.median(low))
    np.testing.assert_array_equal(port_phash.phash(crops[3], device="cpu"), port[3])
    assert port_phash.phash_distance(port[0], port[0]) == 0
    assert port_phash.phash_distance(port[0], port[1]) == jax_phash.phash_distance(jax[0], jax[1])


def test_phash_low_frequencies_match_numpy():
    batch = np.stack([cv2.resize(c[..., 0].astype(np.float32), (32, 32),
                                 interpolation=cv2.INTER_AREA) for c in seeded_crops(8, 8)])
    got = port_phash.low_frequencies(torch.from_numpy(batch)).numpy()
    for row, image in zip(got, batch):
        want = scipy.fftpack.dct(scipy.fftpack.dct(image.astype(np.float64), axis=0),
                                 axis=1)[:8, :8].ravel()
        np.testing.assert_allclose(row, want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_phash_median_is_jax_median_on_ties():
    """Rows whose middle values tie, and rows with many values at the
    median: the bits are `low > jnp.median(low)` exactly."""
    rng = np.random.RandomState(9)
    rows = [rng.randint(-3, 4, 64).astype(np.float32) for _ in range(6)]
    rows.append(np.repeat(np.float32([1.0, 2.0]), 32))  # middle pair 1, 2 -> 1.5
    rows.append(np.zeros(64, np.float32))
    rows.append(np.concatenate([np.full(33, 5.0), np.arange(31)]).astype(np.float32))
    low = np.stack(rows)
    want = np.asarray(low > jnp.median(jnp.asarray(low), axis=1, keepdims=True))
    got = port_phash.bits_from_low_frequencies(torch.from_numpy(low)).numpy()
    np.testing.assert_array_equal(got, want)


def seeded_boxes(rng, count: int, side: int):
    return [BoundingBox(*map(int, rng.randint(-4, side, 2)), *map(int, rng.randint(1, 20, 2)))
            for _ in range(count)]


def test_common_geometry_and_composite_match_jax():
    rng = np.random.RandomState(10)
    for _ in range(10):
        landmarks = [{eye: [tuple(map(int, p)) for p in rng.randint(0, 60, (6, 2))]
                      for eye in ("left_eye", "right_eye")} for _ in range(rng.randint(0, 3))]
        assert port_common.landmarks_to_bounding_boxes(landmarks) == \
            jax_common.landmarks_to_bounding_boxes(landmarks)
        a, b = seeded_boxes(rng, rng.randint(0, 3), 60), seeded_boxes(rng, 3, 60)
        got = port_common.bounding_box_distance(a, b)
        want = jax_common.bounding_box_distance([JaxBox(*x) for x in a], [JaxBox(*x) for x in b])
        assert (got is None and want is None) or tuple(got) == tuple(want)
        boxes = seeded_boxes(rng, 3, 60)
        np.testing.assert_array_equal(
            port_common.draw_mask(ImageResolution(64, 48), boxes),
            jax_common.draw_mask(JaxResolution(64, 48), [JaxBox(*x) for x in boxes]))
        fg, bg = (rng.randint(0, 256, (48, 64, 3)).astype(np.uint8) for _ in range(2))
        composite = port_common.write_boxes_onto_image(fg, bg, boxes)
        np.testing.assert_array_equal(
            composite, jax_common.write_boxes_onto_image(fg, bg, [JaxBox(*x) for x in boxes]))
        if boxes:
            assert not np.array_equal(composite, bg) or np.array_equal(fg, bg)


def cascade(name: str) -> str:
    for directory in port_faces.cascade_dirs():
        if (directory / name).exists():
            return str(directory / name)
    pytest.skip(f"no {name} on this host")


def test_haar_binding_matches_jax():
    """The port's ctypes binding (its own g++ build of native/haar_detector.cpp)
    against JAX's, on seeded smooth grey images: the eye cascade finds
    candidates on them, and both find the same ones."""
    path = cascade("haarcascade_eye.xml")
    port_cascade, jax_cascade = port_haar.parse_cascade_xml(path), jax_haar.parse_cascade_xml(path)
    for field in port_cascade.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(port_cascade, field), getattr(jax_cascade, field))
    assert port_haar.library_path().parent == port_haar.BUILD_DIR
    rng = np.random.RandomState(11)
    found = 0
    for _ in range(3):
        gray = cv2.resize(rng.randint(0, 256, (12, 12)).astype(np.uint8), (96, 96),
                          interpolation=cv2.INTER_CUBIC)
        for kwargs in ({"scale_factor": 1.05, "min_neighbors": 1, "step": 1}, {}):
            got = port_haar.detect(gray, port_cascade, **kwargs)
            assert [tuple(b) for b in got] == [
                tuple(b) for b in jax_haar.detect(gray, jax_cascade, **kwargs)]
            found += len(got)
    assert found > 0
    image = np.stack([gray] * 3, axis=-1)
    cascade("haarcascade_frontalface_default.xml")
    assert port_faces.FaceFinderProxy().face_landmarks(image) == \
        jax_faces.FaceFinderProxy().face_landmarks(image)


def fake_face_landmarks(self, face_image):
    """Deterministic landmarks from the image's bytes: 0-2 faces whose eye
    points sit near the frame's center, some partly outside the frame."""
    image = np.ascontiguousarray(face_image)
    rng = np.random.RandomState(int(hashlib.sha1(image.tobytes()).hexdigest()[:8], 16))
    h, w = image.shape[:2]
    faces = []
    for _ in range(rng.choice([0, 1, 1, 1, 2])):
        cx, cy = w // 2 + rng.randint(-w // 3, w // 3), h // 2 + rng.randint(-h // 3, h // 3)
        size = rng.randint(2, max(3, w // 6))
        faces.append({
            "left_eye": [(int(cx - 2 * size + dx), int(cy + dy)) for dx, dy in
                         rng.randint(-size, size + 1, (6, 2))],
            "right_eye": [(int(cx + 2 * size + dx), int(cy + dy)) for dx, dy in
                          rng.randint(-size, size + 1, (6, 2))],
        })
    return faces


@pytest.mark.parametrize("smoothing,detection_side,skip", [
    (0, None, False), (3, None, False), (0, None, True), (3, 32, True)])
def test_eye_tracking_decisions_match_jax(monkeypatch, smoothing, detection_side, skip):
    monkeypatch.setattr(jax_faces.FaceFinderProxy, "face_landmarks", fake_face_landmarks)
    monkeypatch.setattr(port_faces.FaceFinderProxy, "face_landmarks", fake_face_landmarks)
    rng = np.random.RandomState(12)
    count = 40
    # smooth frames, each drawn twice in a row so that tracks can persist
    frames = [cv2.resize(rng.randint(0, 256, (6, 6, 3)).astype(np.uint8), (48, 48),
                         interpolation=cv2.INTER_CUBIC) for _ in range(count)]
    foregrounds = [frames[i // 2 * 2] for i in range(count)]
    backgrounds = [frames[(i // 2 * 2 + 7) % count] for i in range(count)]
    skip_mask = list(rng.rand(count) < 0.25) if skip else None
    kwargs = dict(min_phash_distance=27, min_bbox_distance=20.0, skip_mask=skip_mask,
                  detection_side=detection_side, temporal_smoothing=smoothing)
    got = port_tracking.compute_eye_tracking_overlay(
        iter(foregrounds), iter(backgrounds), device="cpu", **kwargs)
    want = jax_tracking.compute_eye_tracking_overlay(iter(foregrounds), iter(backgrounds),
                                                     **kwargs)
    got_boxes, want_boxes = list(got.bbox_lists), list(want.bbox_lists)
    got_contexts, want_contexts = list(got.contexts), list(want.contexts)
    assert len(got_boxes) == len(want_boxes) == len(got_contexts) == count
    assert [None if b is None else [tuple(x) for x in b] for b in got_boxes] == \
        [None if b is None else [tuple(x) for x in b] for b in want_boxes]
    assert [tuple(c) for c in got_contexts] == [tuple(c) for c in want_contexts]
    written = sum(c.overlay_written for c in got_contexts)
    assert 0 < written < count, written  # the gates both pass and refuse
    if not smoothing and not skip:  # the pHash gate refuses a pair the bbox gate passes
        assert any(c.bbox_distance is not None and c.bbox_distance < 20.0
                   and not c.overlay_written for c in got_contexts)
    if skip:
        assert all(b is None for b, s in zip(got_boxes, skip_mask) if s)


def test_eye_tracking_without_contexts_and_default_device():
    result = port_tracking.compute_eye_tracking_overlay(
        iter([]), iter([]), 10, 10.0, want_contexts=False, device="cpu")
    assert list(result.bbox_lists) == [] and list(result.contexts) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_tracking.compute_eye_tracking_overlay(iter([]), iter([]), 10, 10.0)


def test_bounded_ordered_map_keeps_order_and_bound():
    """At most 2 x workers items in flight, results in input order."""
    pulled = []

    def items():
        for i in range(40):
            pulled.append(i)
            yield i

    out = port_tracking._bounded_ordered_map(lambda x: x * x, items(), workers=3)
    first = next(out)
    assert first == 0 and len(pulled) <= 2 * 3
    assert [first] + list(out) == [i * i for i in range(40)]


def test_cascade_lookup_order():
    dirs = port_faces.cascade_dirs()
    assert dirs[-1] == Path("/usr/share/opencv4/haarcascades")
    assert [str(d) for d in dirs] == [str(d) for d in jax_faces._CASCADE_DIRS]
