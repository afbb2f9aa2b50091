"""
Read back and re-encode segmented raw spills (the counterpart of
gance_tpu/media/spill.py).

`create_raw_spill_writer` (media/video.py) writes uncompressed BI_RGB AVI
through the native muxer, segmented below AVI's 4 GiB RIFF limit: `out.avi`,
`out.part001.avi`, `out.part002.avi`, ... Each segment plays on its own;
this module gives the spill as one frame stream:

  * `spill_segment_paths`: the segments in playback order; a missing middle
    segment raises instead of dropping frames;
  * `frames_in_spill`: `frames_in_video` over the whole spill, with the same
    metadata, lazy RGB iterator, fps override, exact fps reduction and resize;
  * `reencode_spill`: every frame through the standard (compressed) writer
    into one file, with the audio muxed in when asked.

Host-only departure from gance_tpu, which decodes segments with cv2: the
segments are read by the RIFF reader of `media/native` (`raw_avi_info`,
`raw_avi_frames`), so reading a spill needs no cv2. cv2 is imported only to
resize frames, and by the standard writer of a re-encode.
"""

import re
import tempfile
from itertools import islice
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gance_tpu_torch.media.native import raw_avi_frames, raw_avi_info
from gance_tpu_torch.media.video import (
    VideoFrames,
    add_wavs_to_video,
    create_video_writer,
    reduce_fps_take_every,
    threaded_writer,
)
from gance_tpu_torch.types import ImageResolution
from gance_tpu_torch.utils.logging import LOGGER

_PART_RE = re.compile(r"\.part(\d{3,})$")


def spill_segment_paths(spill_path: Path) -> List[Path]:
    """
    The segments of a raw spill in playback order: the base file, then its
    `.partNNN` siblings. Raises if the base is missing or the part numbers
    have a hole.
    """
    base = Path(spill_path)
    if not base.exists():
        raise ValueError(f"Spill base segment does not exist: {base}")
    parts = []
    for candidate in base.parent.glob(f"{base.stem}.part*{base.suffix}"):
        match = _PART_RE.search(candidate.with_suffix("").name[len(base.stem):])
        if match is None:
            continue
        parts.append((int(match.group(1)), candidate))
    parts.sort()
    expected = list(range(1, len(parts) + 1))
    numbers = [n for n, _ in parts]
    if numbers != expected:
        raise ValueError(
            f"Spill {base} has non-contiguous segments: found part numbers "
            f"{numbers}, expected {expected}"
        )
    return [base] + [p for _, p in parts]


def frames_in_spill(
    spill_path: Path,
    video_fps: Optional[float] = None,
    reduce_fps_to: Optional[float] = None,
    width_height: Optional[Tuple[int, int]] = None,
) -> VideoFrames:
    """
    `frames_in_video` over a whole segmented spill: one lazy RGB iterator over
    every segment, with the fps override, the exact fps reduction (across
    segment boundaries) and the cubic resize.
    """
    segments = spill_segment_paths(spill_path)
    infos = [raw_avi_info(s) for s in segments]
    fps = video_fps if video_fps is not None else infos[0].fps
    frame_count = sum(info.frame_count for info in infos)
    take_every = reduce_fps_take_every(fps, reduce_fps_to)

    def iterate() -> Iterator[np.ndarray]:
        for segment in segments:
            for frame in raw_avi_frames(segment):
                if width_height is not None:
                    import cv2

                    frame = cv2.resize(frame, width_height, interpolation=cv2.INTER_CUBIC)
                yield frame

    frames: Iterator[np.ndarray] = iterate()
    reduced_fps: Optional[float] = None
    reduced_frame_count: Optional[int] = None
    if take_every is not None:
        frames = islice(frames, 0, None, take_every)
        reduced_fps = reduce_fps_to
        reduced_frame_count = -(-frame_count // take_every)

    return VideoFrames(
        original_fps=fps,
        total_frame_count=frame_count,
        original_resolution=ImageResolution(width=infos[0].width, height=infos[0].height),
        frames=frames,
        reduced_fps=reduced_fps,
        reduced_frame_count=reduced_frame_count,
    )


def reencode_spill(
    spill_path: Path,
    output_path: Path,
    high_quality: bool = False,
    audio_paths: Optional[List[Path]] = None,
    video_fps: Optional[float] = None,
    delete_segments: bool = False,
) -> int:
    """
    Re-encode a segmented raw spill into ONE compressed file (with the audio
    muxed in when given), always through the standard writer, never back to
    the spill path, whatever GANCE_TPU_EGRESS says. Returns the frame count.

    :param delete_segments: remove the spill's segments after the re-encode.
    """
    spill_path, output_path = Path(spill_path), Path(output_path)
    video = frames_in_spill(spill_path, video_fps=video_fps)
    fps = video.original_fps

    mux_audio = bool(audio_paths)
    if mux_audio:
        tmp = tempfile.NamedTemporaryFile(suffix=output_path.suffix, delete=False)
        tmp.close()
        target = Path(tmp.name)
    else:
        target = output_path

    writer = threaded_writer(
        create_video_writer(
            target, fps, video.original_resolution,
            high_quality=high_quality, allow_spill=False,
        )
    )
    count = 0
    try:
        for frame in video.frames:
            writer.write(frame)
            count += 1
            if count % 500 == 0:
                LOGGER.info(
                    "Re-encoded %d/%d spill frames into %s",
                    count, video.total_frame_count, output_path,
                )
    finally:
        writer.finish()
    if mux_audio:
        try:
            add_wavs_to_video(target, list(audio_paths), output_path)
        finally:
            target.unlink(missing_ok=True)
    LOGGER.info("Re-encoded %d spill frames into %s", count, output_path)
    if delete_segments:
        for segment in spill_segment_paths(spill_path):
            segment.unlink()
            LOGGER.info("Deleted spill segment %s", segment)
    return count
