"""
The port's media egress (gance_tpu_torch.media), on the CPU: the native raw
AVI writer with and without PCM16 audio read back through a RIFF reader
written here (frames byte for byte, samples exactly, segments rolling at a
small budget), the writer order of `create_video_writer` with ffmpeg and cv2
hidden from its probes, and `write_source_to_disk_forward` passing the frames
through in order, to one raw AVI with the audio interleaved on a host with
neither encoder or with GANCE_TPU_EGRESS=raw-spill.
"""

import struct
from pathlib import Path
from typing import List, Tuple

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from gance_tpu_torch.audio.io import fabricate_percussive_wav  # noqa: E402
from gance_tpu_torch.media import images, native, video  # noqa: E402
from gance_tpu_torch.types import ImageResolution  # noqa: E402


def read_avi(path: Path) -> Tuple[np.ndarray, np.ndarray, List[bytes]]:
    """(frames (N, H, W, 3) RGB, PCM16 samples, chunk ids in stream order) of
    an uncompressed AVI: frames are top-down BGR rows padded to 4 bytes."""
    data = Path(path).read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    frames, audio, order, size = [], [], [], {}

    def walk(offset: int, end: int) -> None:
        while offset + 8 <= end:
            cid = data[offset:offset + 4]
            length = struct.unpack("<I", data[offset + 4:offset + 8])[0]
            body = offset + 8
            if cid == b"LIST":
                walk(body + 4, body + length)
            elif cid == b"avih":
                size["w"], size["h"] = struct.unpack("<II", data[body + 32:body + 40])
            elif cid == b"00db":
                w, h = size["w"], size["h"]
                stride = (w * 3 + 3) & ~3
                rows = np.frombuffer(data, np.uint8, length, body).reshape(h, stride)
                frames.append(rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
            elif cid == b"01wb":
                audio.append(np.frombuffer(data, "<i2", length // 2, body))
            if cid in (b"00db", b"01wb"):
                order.append(cid)
            offset = body + length + (length & 1)

    walk(12, len(data))
    stacked = np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
    return stacked, np.concatenate(audio) if audio else np.zeros(0, np.int16), order


def random_frames(count: int, h: int, w: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(count)]


@pytest.fixture()
def no_encoders(monkeypatch):
    """A host with neither an ffmpeg binary nor cv2."""
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    monkeypatch.setattr(video, "_cv2_available", lambda: False)
    monkeypatch.delenv("GANCE_TPU_EGRESS", raising=False)


@pytest.mark.parametrize("width", [16, 5])
def test_raw_avi_writer_round_trip(tmp_path, width):
    """Frames byte for byte, odd widths (rows padded to 4 bytes) included."""
    frames = random_frames(3, 7, width)
    writer = native.RawAviWriter(tmp_path / "out.avi", width, 7, 30.0)
    for frame in frames:
        writer.write_frame_rgb(frame)
    writer.write_frame_bgr(frames[0][..., ::-1])
    writer.finalize()
    got, audio, order = read_avi(tmp_path / "out.avi")
    np.testing.assert_array_equal(got, np.stack(frames + frames[:1]))
    assert audio.size == 0 and order == [b"00db"] * 4
    assert writer.segment_paths == [tmp_path / "out.avi"]


@pytest.mark.parametrize("channels", [1, 2])
def test_raw_avi_writer_with_audio_segments_and_round_trip(tmp_path, channels):
    """Each frame is followed by round(rate / fps) samples; segments roll at
    the budget and each carries the audio of its own frames; finalize puts
    the rest after the last frame."""
    rate, fps, count = 8000, 25.0, 11
    per_frame = int(round(rate / fps))
    rng = np.random.RandomState(1)
    pcm = rng.randint(-32768, 32768, (per_frame * count + 77, channels)).astype(np.int16)
    frames = random_frames(count, 12, 16, seed=2)
    frame_bytes = 12 * 16 * 3 + 24 + per_frame * channels * 2 + 24
    writer = native.RawAviWriter(tmp_path / "out.avi", 16, 12, fps, segment_bytes=4 * frame_bytes,
                                 pcm=pcm if channels > 1 else pcm[:, 0], audio_rate=rate)
    for frame in frames:
        writer.write_frame_rgb(frame)
    writer.finalize()
    assert len(writer.segment_paths) > 2
    assert writer.segment_paths[1].name == "out.part001.avi"
    all_frames, all_audio, seen = [], [], 0
    for path in writer.segment_paths:
        got, audio, order = read_avi(path)
        assert path.stat().st_size <= 4 * frame_bytes + 4096  # the headers stay under 4 KiB
        n = len(got)
        assert order[: 2 * n] == [b"00db", b"01wb"] * n
        start = seen * per_frame * channels
        np.testing.assert_array_equal(audio[: n * per_frame * channels],
                                      pcm.reshape(-1)[start:start + n * per_frame * channels])
        all_frames.append(got)
        all_audio.append(audio)
        seen += n
    np.testing.assert_array_equal(np.concatenate(all_frames), np.stack(frames))
    np.testing.assert_array_equal(np.concatenate(all_audio), pcm.reshape(-1))


def test_raw_avi_writer_refuses_wrong_frames_and_budgets(tmp_path):
    with pytest.raises(ValueError, match="ceiling"):
        native.RawAviWriter(tmp_path / "x.avi", 4, 4, 30.0, segment_bytes=5 * 1024**3)
    writer = native.RawAviWriter(tmp_path / "x.avi", 4, 4, 30.0)
    with pytest.raises(ValueError, match="declared"):
        writer.write_frame_rgb(np.zeros((4, 5, 3), np.uint8))
    writer.finalize()


def test_native_library_builds_from_the_repo_source():
    path = native.build_library()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert native.SOURCE.name == "avi_muxer.cpp" and native.SOURCE.is_file()
    assert native.build_library() == path  # built once, then found


@pytest.mark.parametrize("source_dtype", ["int16", "float32"])
def test_concatenated_pcm16_joins_wavs_as_int16(tmp_path, source_dtype):
    a = fabricate_percussive_wav(tmp_path / "a.wav", seconds=0.1, dtype=source_dtype)
    b = fabricate_percussive_wav(tmp_path / "b.wav", seconds=0.2, dtype=source_dtype)
    rate, pcm = native.concatenated_pcm16([a, b])
    assert rate == 44100 and pcm.dtype == np.int16 and pcm.shape == (int(0.3 * 44100), 1)
    first = wavfile.read(str(a))[1]
    if source_dtype == "int16":
        np.testing.assert_array_equal(pcm[: len(first), 0], first)
    else:
        np.testing.assert_array_equal(pcm[: len(first), 0],
                                      np.clip(first * 32767.0, -32768, 32767).astype(np.int16))


def test_create_video_writer_order(tmp_path, monkeypatch):
    """raw-spill, then ffmpeg (high quality), then cv2 mp4v; with neither
    encoder it raises instead of writing nothing."""
    res = ImageResolution(8, 8)
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    handle = video.create_video_writer(tmp_path / "a.avi", 30.0, res, high_quality=True)
    assert handle.finish.__self__.__class__ is native.RawAviWriter
    handle.finish()
    monkeypatch.setenv("GANCE_TPU_EGRESS", "auto")
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: "/usr/bin/ffmpeg")
    monkeypatch.setattr(video, "_cv2_available", lambda: False)
    # ffmpeg starts lazily at the first frame, so the handle alone spawns nothing
    assert video.create_video_writer(tmp_path / "b.mp4", 30.0, res,
                                     high_quality=True).write.__name__ == "write_ffmpeg"
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    with pytest.raises(RuntimeError, match="neither an ffmpeg"):
        video.create_video_writer(tmp_path / "c.mp4", 30.0, res, high_quality=True)
    monkeypatch.setattr(video, "_cv2_available", lambda: True)
    pytest.importorskip("cv2")
    handle = video.create_video_writer(tmp_path / "d.mp4", 30.0, res)
    assert handle.write.__name__ == "write_cv2"
    handle.finish()
    monkeypatch.setenv("GANCE_TPU_EGRESS", "nope")
    with pytest.raises(ValueError, match="GANCE_TPU_EGRESS"):
        video.create_video_writer(tmp_path / "e.mp4", 30.0, res)


@pytest.mark.parametrize("with_audio", [False, True])
@pytest.mark.parametrize("mode", ["no encoders", "raw-spill"])
def test_write_forward_writes_one_raw_avi(tmp_path, monkeypatch, mode, with_audio):
    """Without ffmpeg and cv2, or with GANCE_TPU_EGRESS=raw-spill whatever the
    host has: one raw AVI in a single pass, the audio interleaved."""
    if mode == "raw-spill":
        monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    else:
        monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
        monkeypatch.setattr(video, "_cv2_available", lambda: False)
        monkeypatch.delenv("GANCE_TPU_EGRESS", raising=False)
    wav = fabricate_percussive_wav(tmp_path / "song.wav", seconds=0.25)
    frames = random_frames(5, 8, 12, seed=4)
    out = tmp_path / "out.avi"
    passed = list(video.write_source_to_disk_forward(
        iter(frames), out, 20.0, audio_paths=[wav] if with_audio else None))
    assert len(passed) == 5 and all(p is f for p, f in zip(passed, frames))
    got, audio, order = read_avi(out)
    np.testing.assert_array_equal(got, np.stack(frames))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.avi", "song.wav"]
    if with_audio:
        np.testing.assert_array_equal(audio, wavfile.read(str(wav))[1])
        assert order[:4] == [b"00db", b"01wb", b"00db", b"01wb"]
    else:
        assert audio.size == 0


def test_write_forward_yields_frames_in_order_through_cv2(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    monkeypatch.delenv("GANCE_TPU_EGRESS", raising=False)
    frames = [np.full((16, 16, 3), 10 * i, np.uint8) for i in range(6)]
    out = tmp_path / "out.mp4"
    passed = list(video.write_source_to_disk_forward(iter(frames), out, 30.0))
    assert [int(p[0, 0, 0]) for p in passed] == [10 * i for i in range(6)]
    read = video.frames_in_video(out)
    assert read.total_frame_count == 6
    assert len(list(read.frames)) == 6


def test_write_forward_empty_source_and_consume(tmp_path, no_encoders):
    assert list(video.write_source_to_disk_forward(iter(()), tmp_path / "e.avi", 30.0)) == []
    frames = random_frames(2, 4, 4)
    video.write_source_to_disk_consume(iter(frames), tmp_path / "c.avi", 30.0)
    np.testing.assert_array_equal(read_avi(tmp_path / "c.avi")[0], np.stack(frames))


def test_add_wavs_to_video_falls_back_to_a_sidecar(tmp_path, monkeypatch):
    """ffmpeg, then the native MJPEG mux (needs cv2), then a sidecar WAV."""
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)

    def no_mux(*args):
        raise ImportError("no cv2")

    monkeypatch.setattr(native, "mux_video_with_audio", no_mux)
    src = tmp_path / "v.avi"
    src.write_bytes(b"video")
    wav = fabricate_percussive_wav(tmp_path / "s.wav", seconds=0.1)
    video.add_wavs_to_video(src, [wav], tmp_path / "out.avi")
    assert (tmp_path / "out.avi").read_bytes() == b"video"
    assert (tmp_path / "out.audio0.wav").read_bytes() == wav.read_bytes()


def test_threaded_writer_surfaces_encoder_errors():
    written = []

    def write(frame):
        if len(written) == 2:
            raise IOError("disk full")
        written.append(frame)

    handle = video.threaded_writer(video.VideoWriterHandle(write=write, finish=lambda: None),
                                   queue_depth=1)
    with pytest.raises(IOError, match="disk full"):
        for i in range(50):
            handle.write(i)
        handle.finish()
    assert written == [0, 1]


def test_images_round_trip(tmp_path):
    pytest.importorskip("PIL")
    image = random_frames(1, 6, 9)[0]
    images.write_image(image, tmp_path / "a" / "x.png")
    np.testing.assert_array_equal(images.read_image(tmp_path / "a" / "x.png"), image)
