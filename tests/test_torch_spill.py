"""
The port's spill tools (gance_tpu_torch.media.spill, cli/media_tools.py) and
`create_video_writer(allow_spill=False)` against gance_tpu's, on the CPU. A
spill is written by the native raw writer with a small segment budget, so
that seeded 32x24 frames fill three segments. The port reads segments with
its RIFF reader, JAX with cv2: the frames must be equal bit for bit, and so
must the re-encodes (the same cv2 mp4v encoder on both sides).
"""

from pathlib import Path

import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import numpy as np  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from gance_tpu.cli.media_tools import cli as jax_cli  # noqa: E402
from gance_tpu.media import spill as jax_spill  # noqa: E402
from gance_tpu_torch.cli.media_tools import cli  # noqa: E402
from gance_tpu_torch.media import spill, video  # noqa: E402
from gance_tpu_torch.media.native import RawAviWriter, raw_avi_frames, raw_avi_info  # noqa: E402
from gance_tpu_torch.types import ImageResolution  # noqa: E402
from tests.test_torch_media import random_frames  # noqa: E402

FPS = 30.0
FRAMES = 8
SEGMENT_BYTES = 8_000  # three 32x24 frames (2304 bytes of pixels each) a segment


def write_spill(path: Path, frames, segment_bytes: int = SEGMENT_BYTES) -> None:
    height, width = frames[0].shape[:2]
    writer = RawAviWriter(path, width, height, FPS, segment_bytes=segment_bytes)
    for frame in frames:
        writer.write_frame_rgb(frame)
    writer.finalize()


@pytest.fixture()
def spilled(tmp_path):
    frames = random_frames(FRAMES, 24, 32, seed=31)
    base = tmp_path / "render.avi"
    write_spill(base, frames)
    return base, frames


def decoded(path: Path) -> np.ndarray:
    capture = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    capture.release()
    return np.stack(frames)


def test_segment_paths_in_order_and_a_hole_raises(spilled):
    base, _ = spilled
    want = [base, base.with_name("render.part001.avi"), base.with_name("render.part002.avi")]
    assert spill.spill_segment_paths(base) == jax_spill.spill_segment_paths(base) == want
    base.with_name("render.partial.avi").write_bytes(b"not a segment")  # no number: ignored
    assert spill.spill_segment_paths(base) == want
    want[1].unlink()
    for module in (spill, jax_spill):
        with pytest.raises(ValueError, match="non-contiguous"):
            module.spill_segment_paths(base)
    with pytest.raises(ValueError, match="does not exist"):
        spill.spill_segment_paths(base.with_name("missing.avi"))


@pytest.mark.parametrize("options", [
    {}, {"video_fps": 60.0}, {"reduce_fps_to": 10.0}, {"width_height": (20, 12)},
])
def test_frames_in_spill_match_jax(spilled, options):
    base, frames = spilled
    got = spill.frames_in_spill(base, **options)
    want = jax_spill.frames_in_spill(base, **options)
    assert (got.original_fps, got.total_frame_count, tuple(got.original_resolution),
            got.reduced_fps, got.reduced_frame_count) == (
        want.original_fps, want.total_frame_count, tuple(want.original_resolution),
        want.reduced_fps, want.reduced_frame_count)
    assert got.total_frame_count == FRAMES
    got_frames, want_frames = np.stack(list(got.frames)), np.stack(list(want.frames))
    np.testing.assert_array_equal(got_frames, want_frames)
    if not options:
        np.testing.assert_array_equal(got_frames, np.stack(frames))


def test_raw_reader_reads_a_bottom_up_frame():
    """BI_RGB rows bottom-up (a positive height), as other writers store them."""
    import struct
    import tempfile

    frame = random_frames(1, 3, 5, seed=32)[0]
    stride = (5 * 3 + 3) & ~3
    rows = np.zeros((3, stride), np.uint8)
    rows[:, :15] = frame[::-1, :, ::-1].reshape(3, 15)
    movi = b"movi" + b"00db" + struct.pack("<I", rows.nbytes) + rows.tobytes()
    avih = struct.pack("<10I", 33333, 0, 0, 0x10, 1, 0, 1, 0, 5, 3) + bytes(16)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"\0" * 4, 0, 0, 0, 0, 1, 30, 0, 1,
                       rows.nbytes, 0, 0, 0, 0, 5, 3)
    strf = struct.pack("<IiiHHIIiiII", 40, 5, 3, 1, 24, 0, rows.nbytes, 0, 0, 0, 0)
    strl = b"strl" + b"strh" + struct.pack("<I", len(strh)) + strh + b"strf" + struct.pack(
        "<I", len(strf)) + strf
    hdrl = (b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih + b"LIST"
            + struct.pack("<I", len(strl)) + strl)
    body = (b"AVI " + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl + b"LIST"
            + struct.pack("<I", len(movi)) + movi)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bottom_up.avi"
        path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
        info = raw_avi_info(path)
        assert (info.width, info.height, info.fps, info.frame_count, info.top_down) == (
            5, 3, 30.0, 1, False)
        (got,) = list(raw_avi_frames(path))
        np.testing.assert_array_equal(got, frame)


def test_reencode_spill_matches_jax(spilled, tmp_path, monkeypatch):
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")  # the re-encode never spills
    base, _ = spilled
    assert spill.reencode_spill(base, tmp_path / "port.mp4") == FRAMES
    jax_spill.reencode_spill(base, tmp_path / "jax.mp4")
    for name in ("port.mp4", "jax.mp4"):
        with open(tmp_path / name, "rb") as handle:
            assert handle.read(4) != b"RIFF"  # mp4v, not a raw AVI
    got = decoded(tmp_path / "port.mp4")
    assert got.shape == (FRAMES, 24, 32, 3)
    np.testing.assert_array_equal(got, decoded(tmp_path / "jax.mp4"))
    spill.reencode_spill(base, tmp_path / "again.mp4", delete_segments=True)
    assert not list(tmp_path.glob("render*.avi"))


@pytest.mark.parametrize("allow_spill", [True, False])
def test_allow_spill_under_raw_spill(tmp_path, monkeypatch, allow_spill):
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    frames = random_frames(3, 16, 16, seed=33)
    path = tmp_path / "out.mp4"
    writer = video.create_video_writer(path, FPS, ImageResolution(16, 16),
                                       allow_spill=allow_spill)
    for frame in frames:
        writer.write(frame)
    writer.finish()
    raw = path.read_bytes()[:4] == b"RIFF" and raw_avi_info(path).frame_count == 3
    assert raw == allow_spill
    if allow_spill:
        np.testing.assert_array_equal(np.stack(list(raw_avi_frames(path))), np.stack(frames))
    else:
        assert decoded(path).shape == (3, 16, 16, 3)


def test_media_tools_cli_matches_jax(spilled, tmp_path, monkeypatch):
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    base, _ = spilled
    info = CliRunner().invoke(cli, ["spill-info", "--spill-path", str(base)])
    jax_info = CliRunner().invoke(jax_cli, ["spill-info", "--spill-path", str(base)])
    assert info.exit_code == 0, info.output
    assert info.output == jax_info.output
    assert info.output.startswith(f"3 segment(s), {FRAMES} frames, 32x24 @ 30 fps")
    out = tmp_path / "deliverable.mp4"
    result = CliRunner().invoke(cli, ["reencode-spill", "--spill-path", str(base),
                                      "--output-path", str(out), "--fast", "--keep-segments"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert decoded(out).shape == (FRAMES, 24, 32, 3)
    assert base.exists()
    result = CliRunner().invoke(cli, ["reencode-spill", "--spill-path", str(base),
                                      "--output-path", str(out), "--video-fps", "15",
                                      "--delete-segments"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    capture = cv2.VideoCapture(str(out))
    assert capture.get(cv2.CAP_PROP_FPS) == 15.0
    capture.release()
    assert not base.exists()
