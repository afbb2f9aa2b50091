"""
Frame-indexed checkpoint and resume of synthesis renders (the counterpart of
gance_tpu/media/resume.py; the manifest, the part names and both part
formats are the same, so either package resumes a render the other began).

A resumable render streams its frames into self-contained part files under
`<output>.parts/`. Each part is finished, then recorded in a sidecar manifest
(`<output>.resume.json`) that is replaced atomically, so a kill -9 loses at
most the chunk in flight. On resume the pipeline slices its precomputed
inputs at the durable frame count, so finished frames are skipped, not
synthesized again, and new chunks are appended. When the source ends, the
parts are concatenated (with the audio) into the requested output and the
scaffolding is removed; a crash during that finalize re-runs only the
finalize.

The manifest carries a caller-supplied fingerprint of every parameter that
changes the output; resuming with other parameters is refused.

Part formats (a part left unfinished by a crash is not in the manifest and is
discarded on resume):
  * `mp4v`: the cv2 writer. The finalize re-encodes, so the loss compounds:
    a resumed render equals an unbroken resumable render, not a plain one.
  * `raw-avi`: uncompressed parts through the native muxer, byte-capped
    below the 4 GiB RIFF limit so that a part never segments. Frames are
    kept bit for bit, so the output equals an unbroken plain render's.

The default follows the egress mode: `GANCE_TPU_EGRESS=raw-spill` selects
`raw-avi`. A resume keeps the format recorded in its manifest.

Host-only departure from gance_tpu: the finalize reads raw parts back with
the RIFF reader of `media/native` (`raw_avi_frames`), where gance_tpu
decodes them with cv2, so the raw route needs no cv2. cv2 is imported only
where an mp4v part is written or read.
"""

import itertools
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from gance_tpu_torch.media.video import (
    create_raw_spill_writer,
    create_video_writer,
    frames_in_video,
    write_source_to_disk_forward,
)
from gance_tpu_torch.types import image_resolution
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import timed_stage

DEFAULT_CHUNK_FRAMES = 300

# A raw part must stay one file (no .partNNN segment inside a part): cap a
# chunk's pixel bytes below RawAviWriter's own 3.5 GiB roll
# (SEGMENT_BYTES_DEFAULT), leaving room for the chunk and index overhead.
RAW_PART_BYTE_BUDGET = int(3.2 * 1024**3)

PART_FORMATS = ("mp4v", "raw-avi")


def default_parts_format() -> str:
    """raw-avi when the egress mode is raw-spill, else mp4v."""
    egress = os.environ.get("GANCE_TPU_EGRESS", "auto").strip().lower()
    return "raw-avi" if egress == "raw-spill" else "mp4v"


def file_identity(path: Path) -> list:
    """
    `[path, size_bytes, mtime_ns]`: the identity of an input file in a render's
    fingerprint. Size and mtime catch an overwritten input (a retrained
    network at the same path) without hashing it; a JSON list, so that the
    manifest's round trip compares equal.
    """
    stat = Path(path).stat()
    return [str(path), stat.st_size, stat.st_mtime_ns]


def manifest_path(output_path: Path) -> Path:
    return output_path.with_name(output_path.name + ".resume.json")


def parts_directory(output_path: Path) -> Path:
    return output_path.with_name(output_path.name + ".parts")


def _write_manifest(output_path: Path, manifest: Dict[str, Any]) -> None:
    """Replace the sidecar atomically: a crash leaves the old or the new state."""
    path = manifest_path(output_path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, path)


def load_manifest(
    output_path: Path, fingerprint: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """
    The manifest of `output_path`, or None on a fresh start. Raises when the
    manifest was written by a render with other parameters: its parts do not
    belong to the requested output.
    """
    path = manifest_path(output_path)
    if not path.exists():
        return None
    manifest = json.loads(path.read_text())
    if manifest.get("fingerprint") != fingerprint:
        raise ValueError(
            f"{path} belongs to a render with different parameters; delete it "
            f"(and {parts_directory(output_path)}) to start over, or rerun "
            "with the original parameters to resume.\n"
            f"manifest: {json.dumps(manifest.get('fingerprint'), sort_keys=True)}\n"
            f"requested: {json.dumps(fingerprint, sort_keys=True)}"
        )
    return manifest


def durable_frames(output_path: Path, fingerprint: Dict[str, Any]) -> int:
    """Frames already safely on disk for this render (0 on a fresh start)."""
    manifest = load_manifest(output_path, fingerprint)
    if manifest is None:
        return 0
    return int(sum(chunk["frames"] for chunk in manifest["chunks"]))


def _part_frames(path: Path, fmt: str) -> Iterator[np.ndarray]:
    if fmt == "raw-avi":
        from gance_tpu_torch.media.native import raw_avi_frames

        return raw_avi_frames(path)
    return frames_in_video(video_path=path).frames


def write_source_resumable(
    source: Iterator[np.ndarray],
    output_path: Path,
    video_fps: float,
    fingerprint: Dict[str, Any],
    audio_paths: Optional[List[Path]] = None,
    chunk_frames: int = DEFAULT_CHUNK_FRAMES,
    high_quality: bool = True,
    parts_format: Optional[str] = None,
) -> int:
    """
    Write `source`, the frames after the durable prefix (the caller slices its
    inputs at `durable_frames(...)`), into finished parts, then concatenate
    every part (with the audio) into `output_path`.

    :param parts_format: 'mp4v' or 'raw-avi' (module docstring); None takes
        `default_parts_format()`. A resumed render keeps the format of its
        manifest whatever this says.
    :return: the frame count of the finished render.
    """
    output_path = Path(output_path)
    requested_format = parts_format or default_parts_format()
    if requested_format not in PART_FORMATS:
        raise ValueError(
            f"parts_format {requested_format!r}: expected one of {PART_FORMATS}"
        )
    manifest = load_manifest(output_path, fingerprint) or {
        "fingerprint": fingerprint,
        "chunks": [],
        "parts_format": requested_format,
    }
    # manifests older than the field hold mp4v parts
    fmt = manifest.setdefault("parts_format", "mp4v")
    if fmt != requested_format:
        LOGGER.info(
            "Resuming with parts_format=%s from the manifest "
            "(requested %s; one render's parts stay uniform)",
            fmt, requested_format,
        )
    parts_dir = parts_directory(output_path)
    parts_dir.mkdir(parents=True, exist_ok=True)
    # a chunk in flight when a run crashed is not in the manifest: discard it
    recorded = {chunk["name"] for chunk in manifest["chunks"]}
    for stray in sorted(parts_dir.iterdir()):
        if stray.name not in recorded:
            LOGGER.info("Discarding unfinished part %s", stray)
            stray.unlink()

    index = len(manifest["chunks"])
    written = int(sum(chunk["frames"] for chunk in manifest["chunks"]))
    effective_chunk = chunk_frames
    source = iter(source)
    while True:
        chunk = list(itertools.islice(source, effective_chunk))
        if not chunk:
            break
        resolution = image_resolution(chunk[0])
        if fmt == "raw-avi":
            # a raw part must not segment: cap the chunk's bytes, re-slicing
            # the first chunk when the cap is smaller
            cap = max(1, RAW_PART_BYTE_BUDGET // int(np.prod(chunk[0].shape)))
            if cap < effective_chunk:
                LOGGER.info(
                    "Raw parts: chunk capped at %d frames (%d requested) to "
                    "stay below the 4 GiB AVI segment limit", cap, chunk_frames,
                )
                effective_chunk = cap
                source = itertools.chain(chunk[cap:], source)
                chunk = chunk[:cap]
            name = f"part_{index:05d}.avi"
            writer = create_raw_spill_writer(parts_dir / name, video_fps, resolution)
        else:
            name = f"part_{index:05d}.mp4"
            writer = create_video_writer(
                parts_dir / name, video_fps, resolution,
                high_quality=False,  # parts must read back through cv2
                allow_spill=False,
            )
        for frame in chunk:
            writer.write(frame)
        writer.finish()
        manifest["chunks"].append({"name": name, "frames": len(chunk)})
        _write_manifest(output_path, manifest)
        index += 1
        written += len(chunk)
        LOGGER.info(
            "Resumable render: %d frames durable (+%d in %s)", written, len(chunk), name
        )
        # Test seam: a window between durable chunks, so that a kill -9 lands
        # between them deterministically (small renders finish in ms).
        delay = float(os.environ.get("GANCE_TPU_RESUME_CHUNK_DELAY", "0") or 0)
        if delay:
            time.sleep(delay)

    # Finalize: every frame is durable. Killed here, the manifest survives,
    # the next run's source is empty and this block runs again.
    def part_frames() -> Iterator[np.ndarray]:
        for record in manifest["chunks"]:
            yield from _part_frames(parts_dir / record["name"], fmt)

    total = int(sum(chunk["frames"] for chunk in manifest["chunks"]))
    LOGGER.info("Resumable render: finalizing %d frames -> %s", total, output_path)
    with timed_stage("finalize") as finalize:
        for _ in write_source_to_disk_forward(
            source=part_frames(),
            video_path=output_path,
            video_fps=video_fps,
            audio_paths=audio_paths,
            high_quality=high_quality,
        ):
            finalize.tick()
    for record in manifest["chunks"]:
        (parts_dir / record["name"]).unlink(missing_ok=True)
    parts_dir.rmdir()
    manifest_path(output_path).unlink(missing_ok=True)
    return total
