"""
The port's resumable writer (gance_tpu_torch.media.resume) and the flagship's
decision sidecar against gance_tpu's, on the CPU, with seeded 32px frames.

A source that raises after N frames stands in for a crash. Raw parts keep
frames bit for bit, so a resumed raw render equals an unbroken plain render;
mp4v parts re-encode, so there a resumed render is held to JAX's resumed
render of the same frames (the same cv2 encoder on both sides). Across the
packages, each finishes a render the other crashed in, from its manifest and
parts, and the deliverable (raw, GANCE_TPU_EGRESS=raw-spill) equals JAX's
unbroken render frame for frame.
"""

import json
import os
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gance_tpu.media import resume as jax_resume  # noqa: E402
from gance_tpu.media.video import write_source_to_disk_forward as jax_forward  # noqa: E402
from gance_tpu.pipelines import projection_file_blend as jax_pfb  # noqa: E402
from gance_tpu_torch.media import resume  # noqa: E402
from gance_tpu_torch.media.video import write_source_to_disk_forward  # noqa: E402
from gance_tpu_torch.pipelines import projection_file_blend as port_pfb  # noqa: E402
from tests.test_torch_media import random_frames, read_avi  # noqa: E402

FPS = 30.0


def crashing(frames, crash_after: int):
    """Yields `crash_after` frames, then raises as a killed process would stop."""
    for index, frame in enumerate(frames):
        if index == crash_after:
            raise RuntimeError("simulated crash")
        yield frame


def read_frames(path: Path) -> np.ndarray:
    import cv2

    capture = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    capture.release()
    return np.stack(frames)


def consume(iterator) -> None:
    for _ in iterator:
        pass


@pytest.mark.parametrize("parts_format", ["raw-avi", "mp4v"])
def test_crash_then_resume(tmp_path, parts_format):
    pytest.importorskip("cv2")
    frames = random_frames(10, 32, 32, seed=7)
    fingerprint = {"test": "crash", "frames": 10}
    out = tmp_path / "render.mp4"
    with pytest.raises(RuntimeError, match="simulated crash"):
        resume.write_source_resumable(crashing(frames, 6), out, FPS, fingerprint,
                                      chunk_frames=4, parts_format=parts_format)
    assert resume.durable_frames(out, fingerprint) == 4  # the chunk in flight is lost
    assert not out.exists()
    stray = resume.parts_directory(out) / "part_00001.avi"
    stray.write_bytes(b"torn")  # a part the crash left unfinished
    total = resume.write_source_resumable(iter(frames[4:]), out, FPS, fingerprint,
                                          chunk_frames=4, parts_format=parts_format)
    assert total == 10
    assert not resume.manifest_path(out).exists() and not resume.parts_directory(out).exists()
    got = read_frames(out)
    if parts_format == "raw-avi":
        direct = tmp_path / "direct.mp4"
        consume(write_source_to_disk_forward(iter(frames), direct, FPS, high_quality=True))
        np.testing.assert_array_equal(got, read_frames(direct))
    else:  # JAX's resumed render of the same frames: the same encodes
        jax_out = tmp_path / "jax.mp4"
        with pytest.raises(RuntimeError):
            jax_resume.write_source_resumable(crashing(frames, 6), jax_out, FPS, fingerprint,
                                              chunk_frames=4, parts_format=parts_format)
        jax_resume.write_source_resumable(iter(frames[4:]), jax_out, FPS, fingerprint,
                                          chunk_frames=4, parts_format=parts_format)
        np.testing.assert_array_equal(got, read_frames(jax_out))


def test_raw_parts_are_byte_capped(tmp_path, monkeypatch):
    monkeypatch.setattr(resume, "RAW_PART_BYTE_BUDGET", 32 * 32 * 3 * 2)
    frames = random_frames(7, 32, 32, seed=8)
    out = tmp_path / "capped.avi"
    fingerprint = {"t": 1}
    with pytest.raises(RuntimeError):
        resume.write_source_resumable(crashing(frames, 5), out, FPS, fingerprint,
                                      chunk_frames=4, parts_format="raw-avi")
    manifest = resume.load_manifest(out, fingerprint)
    assert [c["frames"] for c in manifest["chunks"]] == [2, 2]  # re-sliced under the cap
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    assert resume.write_source_resumable(iter(frames[4:]), out, FPS, fingerprint,
                                         chunk_frames=4) == 7
    got, _, _ = read_avi(out)
    np.testing.assert_array_equal(got, np.stack(frames))


def test_resume_keeps_the_recorded_parts_format(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    frames = random_frames(8, 32, 32, seed=9)
    out = tmp_path / "mixed.avi"
    fingerprint = {"t": 2}
    with pytest.raises(RuntimeError):
        resume.write_source_resumable(crashing(frames, 5), out, FPS, fingerprint,
                                      chunk_frames=4, parts_format="raw-avi")
    assert resume.load_manifest(out, fingerprint)["parts_format"] == "raw-avi"
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")  # a raw deliverable to compare
    written = []
    real = resume._part_frames

    def recording(path, fmt):
        written.append((path.name, fmt))
        return real(path, fmt)

    monkeypatch.setattr(resume, "_part_frames", recording)
    resume.write_source_resumable(iter(frames[4:]), out, FPS, fingerprint,
                                  chunk_frames=4, parts_format="mp4v")  # the manifest wins
    assert written == [("part_00000.avi", "raw-avi"), ("part_00001.avi", "raw-avi")]
    np.testing.assert_array_equal(read_avi(out)[0], np.stack(frames))


def test_another_fingerprint_is_refused(tmp_path):
    frames = random_frames(6, 16, 16, seed=10)
    out = tmp_path / "x.avi"
    with pytest.raises(RuntimeError):
        resume.write_source_resumable(crashing(frames, 5), out, FPS, {"side": 16},
                                      chunk_frames=2, parts_format="raw-avi")
    for module in (resume, jax_resume):
        with pytest.raises(ValueError, match="different parameters"):
            module.durable_frames(out, {"side": 32})
    with pytest.raises(ValueError, match="different parameters"):
        resume.write_source_resumable(iter(frames[4:]), out, FPS, {"side": 32},
                                      parts_format="raw-avi")
    assert resume.durable_frames(out, {"side": 16}) == 4


def test_file_identity_catches_an_overwritten_input(tmp_path):
    path = tmp_path / "net.pkl"
    path.write_bytes(b"a" * 100)
    first = resume.file_identity(path)
    assert first == jax_resume.file_identity(path)
    assert json.loads(json.dumps(first)) == first  # survives the manifest's round trip
    path.write_bytes(b"b" * 101)  # retrained, another size
    assert resume.file_identity(path) != first
    path.write_bytes(b"c" * 100)  # the same size, a later mtime
    stat = path.stat()
    os.utime(path, ns=(stat.st_atime_ns, first[2] + 1_000_000))
    assert resume.file_identity(path) != first


SIDECAR_FINGERPRINT = {"pipeline": "projection_file_blend", "track_length": 5}
HEADER = json.dumps({"fingerprint": SIDECAR_FINGERPRINT})
RECORDS = [json.dumps({"boxes": None}), json.dumps({"boxes": [[1, 2, 3, 4], [5, 6, 7, 8]]}),
           json.dumps({"boxes": [[9, 10, 11, 12]]})]


@pytest.mark.parametrize("case,text,kept", [
    ("whole", "\n".join([HEADER, *RECORDS]) + "\n", 3),
    ("torn final line", "\n".join([HEADER, *RECORDS[:2], RECORDS[2][:7]]), 2),
    ("torn middle line", "\n".join([HEADER, RECORDS[0], RECORDS[1][:5], RECORDS[2]]) + "\n", 0),
    ("torn header", HEADER[:9], 0),
    ("another fingerprint", json.dumps({"fingerprint": {"x": 1}}) + "\n" + RECORDS[0] + "\n", 0),
])
def test_decision_sidecar_matches_jax(tmp_path, case, text, kept):
    loaded = {}
    for name, module in (("jax", jax_pfb), ("port", port_pfb)):
        path = tmp_path / name / "out.avi.overlay.jsonl"
        path.parent.mkdir()
        path.write_text(text)
        decisions = module._load_overlay_decisions(path, SIDECAR_FINGERPRINT)
        loaded[name] = ([None if d is None else [tuple(b) for b in d] for d in decisions],
                        path.read_text() if path.exists() else None)
    assert loaded["port"] == loaded["jax"], case
    decisions, left = loaded["port"]
    assert len(decisions) == kept
    if case == "torn final line":  # truncated, so the next append starts a line
        assert left == "\n".join([HEADER, *RECORDS[:2]]) + "\n"
    if kept == 0 and case != "whole":
        assert left is None  # the cache is discarded


def test_decision_checkpoint_appends_as_jax_does(tmp_path):
    boxes = [None, [port_pfb.BoundingBox(1, 2, 3, 4)]]
    for name, module in (("jax", jax_pfb), ("port", port_pfb)):
        path = tmp_path / f"{name}.jsonl"
        assert list(module._checkpoint_decisions(path, SIDECAR_FINGERPRINT, 0, iter(boxes))) == boxes
        assert list(module._checkpoint_decisions(path, SIDECAR_FINGERPRINT, 2, iter(boxes))) == boxes
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()


@pytest.mark.parametrize("crashed_by,finished_by", [("jax", "port"), ("port", "jax")])
def test_cross_package_resume_equals_jax_unbroken(tmp_path, monkeypatch, crashed_by, finished_by):
    """One package crashes after two chunks; the other finishes the render from
    its manifest and parts."""
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    modules = {"jax": jax_resume, "port": resume}
    frames = random_frames(12, 32, 24, seed=11)
    fingerprint = {"pipeline": "cross", "frames": 12}
    out = tmp_path / "render.avi"
    with pytest.raises(RuntimeError):
        modules[crashed_by].write_source_resumable(crashing(frames, 9), out, FPS, fingerprint,
                                                   chunk_frames=4)
    manifest = json.loads(resume.manifest_path(out).read_text())
    assert manifest["parts_format"] == "raw-avi" and len(manifest["chunks"]) == 2
    start = modules[finished_by].durable_frames(out, fingerprint)
    assert start == 8
    assert modules[finished_by].write_source_resumable(
        iter(frames[start:]), out, FPS, fingerprint, chunk_frames=4) == 12
    assert not resume.parts_directory(out).exists()

    unbroken = tmp_path / "unbroken.avi"
    for _ in jax_forward(iter(frames), unbroken, FPS, high_quality=True):
        pass
    got, want = read_avi(out)[0], read_avi(unbroken)[0]
    assert got.shape == (12, 32, 24, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(frames))
