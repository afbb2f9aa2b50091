"""
CLI: tools for raw-spill renders with the port (the counterpart of
gance_tpu/cli/media_tools.py, with the same commands and option names).

`GANCE_TPU_EGRESS=raw-spill` writes any render as uncompressed AVI segments at
disk rate; these commands are the offline half: inspect a spill, and
re-encode it into one compressed file where encode compute exists.

    python -m gance_tpu_torch.cli.media_tools spill-info --spill-path out.avi
    python -m gance_tpu_torch.cli.media_tools reencode-spill --spill-path out.avi \
        --output-path out.mp4 [--audio-path song.wav] [--delete-segments]
"""

from pathlib import Path
from typing import Optional, Tuple

import click

from gance_tpu_torch.utils.logging import LOGGER


@click.group()
def cli() -> None:
    """Utilities for raw-spill renders (inspect, re-encode)."""


@cli.command(name="spill-info")
@click.option(
    "--spill-path", type=click.Path(exists=True, dir_okay=False), required=True,
    help="Base segment of the spill (its .partNNN siblings are discovered).",
)
def spill_info(spill_path: str) -> None:
    """Print a spill's segments, resolution, fps, and total frame count."""
    from gance_tpu_torch.media.spill import frames_in_spill, spill_segment_paths

    segments = spill_segment_paths(Path(spill_path))
    video = frames_in_spill(Path(spill_path))
    total_bytes = sum(p.stat().st_size for p in segments)
    click.echo(
        f"{len(segments)} segment(s), {video.total_frame_count} frames, "
        f"{video.original_resolution.width}x{video.original_resolution.height} "
        f"@ {video.original_fps:g} fps, {total_bytes / 1024**2:.1f} MiB"
    )
    for path in segments:
        click.echo(f"  {path} ({path.stat().st_size / 1024**2:.1f} MiB)")


@cli.command(name="reencode-spill")
@click.option(
    "--spill-path", type=click.Path(exists=True, dir_okay=False), required=True,
    help="Base segment of the spill (its .partNNN siblings are discovered).",
)
@click.option(
    "--output-path", type=click.Path(dir_okay=False), required=True,
    help="Single compressed output file (never spills, regardless of env).",
)
@click.option(
    "--audio-path", "audio_paths",
    type=click.Path(exists=True, dir_okay=False), multiple=True,
    help="Audio file(s) to mux in, concatenated in the order given.",
)
@click.option(
    "--high-quality/--fast", default=False,
    help="Use the libx264 crf-18 profile when ffmpeg exists (else cv2 mp4v).",
)
@click.option(
    "--video-fps", type=click.FloatRange(min=0), default=None,
    help="Override the fps recorded in the spill headers.",
)
@click.option(
    "--delete-segments/--keep-segments", default=False,
    help="Remove the spill segments after a successful re-encode.",
)
def reencode_spill_command(
    spill_path: str,
    output_path: str,
    audio_paths: Tuple[str, ...],
    high_quality: bool,
    video_fps: Optional[float],
    delete_segments: bool,
) -> None:
    """Re-encode a segmented raw spill into one compressed deliverable."""
    from gance_tpu_torch.media.spill import reencode_spill

    LOGGER.info("Re-encoding spill %s -> %s", spill_path, output_path)
    reencode_spill(
        Path(spill_path),
        Path(output_path),
        high_quality=high_quality,
        audio_paths=[Path(p) for p in audio_paths],
        video_fps=video_fps,
        delete_segments=delete_segments,
    )


if __name__ == "__main__":
    cli()
