"""
Streaming video read/write and audio muxing (the counterpart of
gance_tpu/media/video.py).

The egress order is gance_tpu's:
  1. GANCE_TPU_EGRESS=raw-spill: uncompressed AVI through the native muxer;
  2. ffmpeg (libx264 crf 18, the `high_quality` profile) when a binary exists;
  3. cv2 mp4v;
  4. for the audio mux: ffmpeg, then the native MJPEG mux with cv2, then a
     sidecar WAV.

Two departures, both in `write_source_to_disk_forward` and both host egress
only (no device work depends on them). The port's raw writer
(`media/native.RawAviWriter`) carries the audio itself, interleaved as PCM16
after each frame, so:
  * with GANCE_TPU_EGRESS=raw-spill, an output with audio is one raw AVI
    written in a single pass, where gance_tpu (whose raw writer has no audio)
    falls back to the standard writer and a mux;
  * on a host with neither ffmpeg nor cv2, where the order above cannot
    write any file, the output is that raw AVI too, and a warning names the
    container.
cv2 is imported only inside the functions that use it, so the module
imports on a host without it.
"""

import importlib.util
import os
import shutil
import subprocess
import tempfile
from itertools import islice
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gance_tpu_torch.types import ImageResolution, ImageSourceType, image_resolution
from gance_tpu_torch.utils.divisor import divide_no_remainder
from gance_tpu_torch.utils.logging import LOGGER

_MULTI_PROCESS_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"


class VideoFrames(NamedTuple):
    """
    Metadata + lazy frame iterator (reference video_common.py:198-206).
    `original_fps` / `total_frame_count` describe the SOURCE FILE even when an fps
    reduction is applied (the reference's provenance contract); the reduced frame
    count is ceil(total / take_every) when `reduce_fps_to` was given.
    """

    original_fps: float
    total_frame_count: int
    original_resolution: ImageResolution
    frames: ImageSourceType
    reduced_fps: Optional[float] = None
    reduced_frame_count: Optional[int] = None

    @property
    def effective_fps(self) -> float:
        return self.reduced_fps if self.reduced_fps is not None else self.original_fps

    @property
    def effective_frame_count(self) -> int:
        return (
            self.reduced_frame_count
            if self.reduced_frame_count is not None
            else self.total_frame_count
        )


def reduce_fps_take_every(original_fps: float, new_fps: Optional[float]) -> Optional[int]:
    """
    How many frames to skip for an exact integer fps reduction; None when no
    reduction requested (reference :209-226; raises unless divisible).
    """
    if new_fps is None:
        return None
    return divide_no_remainder(original_fps, new_fps)


def frames_in_video(
    video_path: Path,
    video_fps: Optional[float] = None,
    reduce_fps_to: Optional[float] = None,
    width_height: Optional[Tuple[int, int]] = None,
) -> VideoFrames:
    """
    Open a video and expose its RGB frames as a lazy iterator.

    :param video_fps: override the container's fps metadata.
    :param reduce_fps_to: keep every Nth frame for an exact fps reduction.
    :param width_height: optional resize of each frame (cubic).
    """
    import cv2

    video = cv2.VideoCapture(str(video_path))
    if not video.isOpened():
        raise ValueError(f"Couldn't open video file: {video_path}")

    fps = video_fps if video_fps is not None else float(video.get(cv2.CAP_PROP_FPS))
    frame_count = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
    resolution = ImageResolution(
        width=int(video.get(cv2.CAP_PROP_FRAME_WIDTH)),
        height=int(video.get(cv2.CAP_PROP_FRAME_HEIGHT)),
    )
    take_every = reduce_fps_take_every(fps, reduce_fps_to)

    def iterate() -> Iterator[np.ndarray]:
        # finally: an abandoned iterator (e.g. islice'd to a frame cap) must
        # still release the decoder handle when the generator is closed/GC'd,
        # not only on full exhaustion.
        try:
            while True:
                ret, frame = video.read()
                if not ret:
                    break
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if width_height is not None:
                    frame = cv2.resize(
                        frame, width_height, interpolation=cv2.INTER_CUBIC
                    )
                yield frame
        finally:
            video.release()

    frames: Iterator[np.ndarray] = iterate()
    reduced_fps: Optional[float] = None
    reduced_frame_count: Optional[int] = None
    if take_every is not None:
        frames = islice(frames, 0, None, take_every)
        reduced_fps = reduce_fps_to
        # islice(step=k) yields ceil(n / k) items, not n // k.
        reduced_frame_count = -(-frame_count // take_every)

    return VideoFrames(
        original_fps=fps,
        total_frame_count=frame_count,
        original_resolution=resolution,
        frames=frames,
        reduced_fps=reduced_fps,
        reduced_frame_count=reduced_frame_count,
    )


class VideoWriterHandle(NamedTuple):
    """write(frame)/finish() pair (reference VideoOutputController, :82-93)."""

    write: "callable"
    finish: "callable"


def _ffmpeg_binary() -> Optional[str]:
    return shutil.which("ffmpeg")


def _egress_mode() -> str:
    """GANCE_TPU_EGRESS: 'auto' (default) or 'raw-spill'; other values raise."""
    egress = os.environ.get("GANCE_TPU_EGRESS", "auto").strip().lower()
    if egress not in ("auto", "raw-spill"):
        raise ValueError(
            f"GANCE_TPU_EGRESS={egress!r}: expected 'auto' or 'raw-spill'"
        )
    return egress


def _cv2_available() -> bool:
    """Whether cv2 can be imported (probed without importing it)."""
    return importlib.util.find_spec("cv2") is not None


def create_video_writer(
    video_path: Path,
    video_fps: float,
    resolution: ImageResolution,
    high_quality: bool = False,
) -> VideoWriterHandle:
    """
    Create a frame sink. `high_quality` selects the ffmpeg libx264 crf-18 profile
    (reference :108-140) when ffmpeg exists; otherwise cv2 mp4v (:143-163) with the
    reference's resolution guard semantics (frames must match the declared size).

    GANCE_TPU_EGRESS=raw-spill routes every writer to the uncompressed-AVI
    O_DIRECT spill path instead (re-encode the spill offline). Output is AVI
    content regardless of the requested suffix. With neither ffmpeg nor cv2
    on the host, and no spill asked for, this raises.
    """
    video_path = Path(video_path)
    video_path.parent.mkdir(parents=True, exist_ok=True)

    if _egress_mode() == "raw-spill":
        LOGGER.info("Raw-spill egress: uncompressed AVI content at %s", video_path)
        return create_raw_spill_writer(video_path, video_fps, resolution)

    if high_quality and _ffmpeg_binary():
        # The reference's exact "YouTube-tuned" x264 profile (video_common.py
        # :108-140): yadif + scale filter, crf 18, 2 B-frames, no edit list,
        # faststart, yuv422p. Like the reference's WriteGear, the input frame
        # size is taken from the FIRST frame and the scale filter maps it to
        # the declared output resolution — so mismatched sources are scaled,
        # not rejected. ffmpeg starts lazily on the first write for that.
        state = {"proc": None, "input_resolution": None}

        def ffmpeg_args(input_resolution: ImageResolution) -> list:
            # -use_editlist / -movflags are mov/mp4-muxer PRIVATE options; on
            # any other container (mkv, avi) ffmpeg aborts at startup with
            # "Option not found" — emit them only where they exist. The
            # reference only ever wrote .mp4, so the mp4 argv is its exact
            # profile and other containers simply omit the muxer knobs.
            mp4_like = Path(video_path).suffix.lower() in (".mp4", ".mov", ".m4v")
            return [
                _ffmpeg_binary(),
                "-y",
                "-f", "rawvideo",
                "-pix_fmt", "rgb24",
                "-s", f"{input_resolution.width}x{input_resolution.height}",
                "-r", str(video_fps),
                "-i", "-",
                "-vf", f"yadif,scale={resolution.width}:{resolution.height}",
                "-vcodec", "libx264",
                "-crf", "18",
                "-bf", "2",
                *(
                    ["-use_editlist", "0", "-movflags", "+faststart"]
                    if mp4_like
                    else []
                ),
                "-pix_fmt", "yuv422p",
                str(video_path),
            ]

        def write_ffmpeg(frame: np.ndarray) -> None:
            if state["proc"] is None:
                state["input_resolution"] = image_resolution(frame)
                state["proc"] = subprocess.Popen(
                    ffmpeg_args(state["input_resolution"]),
                    stdin=subprocess.PIPE,
                    stderr=subprocess.DEVNULL,
                )
            # Frames after the first must match it: the rawvideo pipe slices
            # the byte stream at the declared WxH, so a size change would
            # misalign EVERY later frame — silent garbage.
            elif image_resolution(frame) != state["input_resolution"]:
                raise ValueError(
                    f"Frame resolution {image_resolution(frame)} != first "
                    f"frame resolution {state['input_resolution']}"
                )
            state["proc"].stdin.write(np.ascontiguousarray(frame, np.uint8).tobytes())

        def finish_ffmpeg() -> None:
            proc = state["proc"]
            if proc is None:  # zero frames written — nothing to mux
                return
            proc.stdin.close()
            if proc.wait() != 0:
                raise RuntimeError(
                    f"ffmpeg exited {proc.returncode} writing {video_path} "
                    "(disk full / codec+container mismatch?)"
                )

        return VideoWriterHandle(write=write_ffmpeg, finish=finish_ffmpeg)

    if not _cv2_available():
        raise RuntimeError(
            f"No video encoder for {video_path}: this host has neither an ffmpeg "
            "binary nor cv2. Set GANCE_TPU_EGRESS=raw-spill for uncompressed AVI, "
            "or write through write_source_to_disk_forward, which writes a raw AVI "
            "on such a host."
        )
    if high_quality:
        LOGGER.warning(
            "high_quality writer requested but no ffmpeg binary found; using cv2 mp4v."
        )
    import cv2

    writer = cv2.VideoWriter(
        str(video_path),
        cv2.VideoWriter_fourcc(*"mp4v"),
        video_fps,
        (resolution.width, resolution.height),
    )
    if not writer.isOpened():
        raise ValueError(f"Couldn't open video writer at {video_path}")

    def write_cv2(frame: np.ndarray) -> None:
        if image_resolution(frame) != resolution:
            raise ValueError(
                f"Frame resolution {image_resolution(frame)} != writer resolution {resolution}"
            )
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def finish_cv2() -> None:
        writer.release()

    return VideoWriterHandle(write=write_cv2, finish=finish_cv2)


def create_raw_spill_writer(
    video_path: Path,
    video_fps: float,
    resolution: ImageResolution,
    audio_paths: Optional[Sequence[Path]] = None,
) -> VideoWriterHandle:
    """
    Maximum-rate egress: uncompressed BI_RGB AVI through the native muxer's
    O_DIRECT path. Output segments below AVI's 4 GiB limit (`.partNNN.avi`
    siblings); each segment plays standalone. With `audio_paths`, the WAVs'
    samples (concatenated, PCM16) are interleaved after each frame, each
    segment carrying the audio of its own frames.
    """
    from gance_tpu_torch.media.native import RawAviWriter, concatenated_pcm16

    rate, pcm = concatenated_pcm16(audio_paths or [])
    writer = RawAviWriter(
        Path(video_path), resolution.width, resolution.height, video_fps,
        pcm=pcm if rate else None, audio_rate=rate,
    )

    def write(frame: np.ndarray) -> None:
        if image_resolution(frame) != resolution:
            raise ValueError(
                f"Frame resolution {image_resolution(frame)} != writer resolution {resolution}"
            )
        writer.write_frame_rgb(frame)

    return VideoWriterHandle(write=write, finish=writer.finalize)


def threaded_writer(
    handle: VideoWriterHandle, queue_depth: int = 8
) -> VideoWriterHandle:
    """
    Move encode off the caller's thread: writes enqueue into a bounded queue
    drained by a dedicated encoder thread, so video encode overlaps synthesis /
    device egress instead of serializing with it (the 4K/60 target's "bottleneck
    only by synthesis FLOPs", BASELINE.md). `finish()` drains the queue, joins
    the thread, and re-raises any encoder error.
    """
    import queue as queue_mod
    import threading

    frames: "queue_mod.Queue" = queue_mod.Queue(maxsize=queue_depth)
    errors: List[BaseException] = []

    def drain() -> None:
        while True:
            item = frames.get()
            if item is None:
                return
            try:
                handle.write(item)
            except BaseException as e:
                errors.append(e)
                # KEEP consuming (discarding) until the None sentinel: a
                # producer blocked in put() on the full bounded queue would
                # otherwise deadlock with no consumer, and finish()'s own
                # put(None) would block forever — the error must surface,
                # not hang the pipeline.
                while frames.get() is not None:
                    pass
                return

    worker = threading.Thread(target=drain, daemon=True, name="video-encoder")
    worker.start()

    def write(frame: np.ndarray) -> None:
        if errors:
            raise errors[0]
        frames.put(frame)

    def finish() -> None:
        frames.put(None)
        worker.join()
        if errors:
            # Best-effort finalize (release encoder handles) but surface the
            # original encode error, not any secondary finalize failure.
            try:
                handle.finish()
            except BaseException:
                pass
            raise errors[0]
        handle.finish()

    return VideoWriterHandle(write=write, finish=finish)


def add_wavs_to_video(
    video_path: Path, audio_paths: List[Path], output_path: Path
) -> None:
    """
    Mux audio track(s) into a video (reference :24-79: ffmpeg concat of audio
    streams, video stream copied). Preference order:
      1. ffmpeg binary (stream copy + flac audio, as the reference does),
      2. native C++ AVI muxer (re-encodes frames as MJPEG, audio as PCM16),
      3. sidecar .wav copy next to the output + warning.
    """
    video_path, output_path = Path(video_path), Path(output_path)
    ffmpeg = _ffmpeg_binary()
    if ffmpeg:
        inputs: List[str] = []
        for p in [video_path] + list(audio_paths):
            inputs.extend(["-i", str(p)])
        n_audio = len(audio_paths)
        concat = "".join(f"[{i + 1}:a]" for i in range(n_audio))
        cmd = [ffmpeg, "-y", *inputs]
        if n_audio > 1:
            cmd += [
                "-filter_complex", f"{concat}concat=n={n_audio}:v=0:a=1[a]",
                "-map", "0:v", "-map", "[a]",
            ]
        else:
            cmd += ["-map", "0:v", "-map", "1:a"]
        # -strict -2: stock ffmpeg gates FLAC-in-MP4 as experimental; the
        # reference wrote flac audio into .mp4 outputs, so keep its codec
        # choice and unlock the mux explicitly.
        cmd += ["-c:v", "copy", "-c:a", "flac", "-strict", "-2", str(output_path)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError as e:
            LOGGER.error(
                "ffmpeg audio mux failed (rc=%d): %s",
                e.returncode,
                (e.stderr or b"").decode(errors="replace")[-2000:],
            )
            raise
        return

    try:
        from gance_tpu_torch.media.native import mux_video_with_audio

        mux_video_with_audio(video_path, list(audio_paths), output_path)
        return
    except Exception as e:  # no cv2, or no g++ to build the muxer
        LOGGER.warning("Native AVI mux unavailable (%s); writing sidecar audio.", e)

    shutil.copyfile(video_path, output_path)
    for i, audio in enumerate(audio_paths):
        sidecar = output_path.with_suffix(f".audio{i}.wav")
        shutil.copyfile(audio, sidecar)
        LOGGER.warning("Audio written as sidecar: %s", sidecar)


def write_source_to_disk_forward(
    source: ImageSourceType,
    video_path: Path,
    video_fps: float,
    audio_paths: Optional[List[Path]] = None,
    high_quality: bool = False,
) -> ImageSourceType:
    """
    Write `source` to disk while re-yielding each frame (the streaming
    tee-through primitive). The first frame is peeked to learn the
    resolution; with audio, video goes to a temp file that is then muxed.
    With GANCE_TPU_EGRESS=raw-spill, or on a host with neither ffmpeg nor
    cv2, the video and its audio go to one raw AVI in a single pass instead.

    One process only: under a torch.distributed group of more than one
    process this raises.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"multi-process writing is not ported yet: {_MULTI_PROCESS_ITEM}"
        )

    source = iter(source)
    try:
        first = next(source)
    except StopIteration:
        LOGGER.warning("write_source_to_disk_forward: empty source for %s", video_path)

        def empty() -> Iterator[np.ndarray]:
            return iter(())

        return empty()

    resolution = image_resolution(first)
    mux_audio = bool(audio_paths)
    spill = _egress_mode() == "raw-spill"
    if spill or (not _ffmpeg_binary() and not _cv2_available()):
        container = "one AVI (RIFF) of uncompressed RGB frames" + (
            " with the audio interleaved as PCM16" if mux_audio else "")
        if spill:
            LOGGER.info("Raw-spill egress: %s is %s, written in one pass.", video_path, container)
        else:
            LOGGER.warning("Neither ffmpeg nor cv2 on this host: %s is %s, written in one "
                           "pass.", video_path, container)
        writer = threaded_writer(create_raw_spill_writer(
            Path(video_path), video_fps, resolution, audio_paths=audio_paths))
        return _forward(first, source, writer, video_path)
    if mux_audio:
        tmp = tempfile.NamedTemporaryFile(suffix=Path(video_path).suffix, delete=False)
        tmp.close()
        target = Path(tmp.name)
    else:
        target = Path(video_path)

    # Encode runs on its own thread behind a bounded queue so the producer
    # (synthesis / device egress) never stalls on the encoder.
    writer = threaded_writer(
        create_video_writer(target, video_fps, resolution, high_quality=high_quality)
    )

    after = None
    if mux_audio:
        def after() -> None:
            add_wavs_to_video(target, list(audio_paths), Path(video_path))
            target.unlink(missing_ok=True)

    return _forward(first, source, writer, video_path, after)


def _forward(first: np.ndarray, source: Iterator[np.ndarray], writer: VideoWriterHandle,
             video_path: Path, after=None) -> Iterator[np.ndarray]:
    """Write `first` and then the rest of `source`, yielding each frame after
    its write; finish the writer (then run `after`) when the stream ends."""
    count = 0
    try:
        frame = first
        while True:
            writer.write(frame)
            count += 1
            if count % 100 == 0:
                LOGGER.info("Wrote frame %d to %s", count, video_path)
            yield frame
            frame = next(source)
    except StopIteration:
        pass
    finally:
        writer.finish()
        if after is not None:
            after()


def write_source_to_disk_consume(
    source: ImageSourceType,
    video_path: Path,
    video_fps: float,
    audio_paths: Optional[List[Path]] = None,
    high_quality: bool = False,
) -> None:
    """Write the whole source to disk, discarding frames (reference :371-396)."""
    for _ in write_source_to_disk_forward(
        source, video_path, video_fps, audio_paths, high_quality
    ):
        pass


def resize_source(
    source: ImageSourceType, width_height: Tuple[int, int]
) -> ImageSourceType:
    """Cubic-resize every frame (cv2)."""
    import cv2

    return (
        cv2.resize(frame, width_height, interpolation=cv2.INTER_CUBIC) for frame in source
    )


def scale_square_source_duplicate(
    source: ImageSourceType, output_side_length: int, frame_multiplier: int = 1
) -> ImageSourceType:
    """
    Cubic-resize square frames on the host (cv2 INTER_CUBIC) and repeat each
    frame `frame_multiplier` times: the fps up-conversion used when the output
    fps exceeds a projection file's.
    """

    def iterate() -> Iterator[np.ndarray]:
        import cv2

        for frame in source:
            resized = cv2.resize(
                frame,
                (output_side_length, output_side_length),
                interpolation=cv2.INTER_CUBIC,
            )
            for _ in range(frame_multiplier):
                yield resized

    return iterate()
