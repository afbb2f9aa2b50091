"""
CLI: music -> StyleGAN2 music video with the port (the counterpart of
gance_tpu/cli/music_into_networks.py, with the same option names plus
--device).

    python -m gance_tpu_torch.cli.music_into_networks noise-blend \
        --wav song.wav --output-path video.avi --networks-directory nets \
        --output-fps 30 --output-side-length 1024 [--device cuda]
    python -m gance_tpu_torch.cli.music_into_networks projection-file-blend \
        --wav song.wav --output-path video.avi --networks-directory nets \
        --projection-file-path projection.hdf5 --blend-depth 10 \
        --phash-distance 30 --bbox-distance 50 --track-length 5 [--device cuda]

Both commands take JAX's placement options: --data-parallel N (a
('data', 'model') mesh over this process's devices), --one-network-per-device
and --network-parallel, one at a time, and --dist-coordinator host:port
--dist-num-processes P --dist-process-id i to join P processes, which default
to pure data parallelism over every process's devices; only process 0 writes
the video.
"""

from pathlib import Path
from typing import Optional, Tuple

import click

from gance_tpu_torch.cli.common import (
    common_command_options,
    dump_run_config,
    maybe_initialize_distributed,
    resolve_networks,
    setup_log,
)


@click.group()
def cli() -> None:
    """Map music into the latent space of StyleGAN2 networks."""
    from gance_tpu_torch.utils.profiling import start_memwatch

    start_memwatch()  # no-op unless GANCE_TPU_MEMWATCH is set


@cli.command(name="noise-blend")
@common_command_options
def noise_blend(  # pylint: disable=too-many-arguments,too-many-locals
    wav: Tuple[str, ...],
    output_path: str,
    networks_directory: Optional[str],
    network_path: Tuple[str, ...],
    networks_json: Optional[str],
    frames_to_visualize: Optional[int],
    output_fps: float,
    output_side_length: int,
    debug_path: Optional[str],
    debug_window: int,
    debug_side_length: int,
    debug_3d: bool,
    alpha: float,
    fft_roll_enabled: bool,
    fft_amplitude_range: Tuple[float, float],
    compute_dtype: Optional[str],
    trace_dir: Optional[str],
    data_parallel: Optional[int],
    one_network_per_device: bool,
    network_parallel: bool,
    dist_coordinator: Optional[str],
    dist_num_processes: Optional[int],
    dist_process_id: Optional[int],
    resumable: bool,
    resume_chunk_frames: int,
    device: str,
    run_config: Optional[str],
    log: Optional[str],
) -> None:
    """Blend audio spectrogram with smoothed noise and synthesize a video."""
    setup_log(log)
    maybe_initialize_distributed(dist_coordinator, dist_num_processes, dist_process_id, device)
    network_paths = resolve_networks(networks_directory, network_path, networks_json)
    dump_run_config(run_config, dict(locals()))

    from gance_tpu_torch.pipelines.noise_blend import noise_blend_api

    noise_blend_api(
        wav=[Path(w) for w in wav],
        output_path=Path(output_path),
        network_paths=network_paths,
        frames_to_visualize=frames_to_visualize,
        output_fps=output_fps,
        output_side_length=output_side_length,
        debug_path=Path(debug_path) if debug_path else None,
        debug_window=debug_window,
        debug_side_length=debug_side_length,
        alpha=alpha,
        fft_roll_enabled=fft_roll_enabled,
        fft_amplitude_range=fft_amplitude_range,
        compute_dtype=compute_dtype,
        trace_dir=Path(trace_dir) if trace_dir else None,
        debug_3d=debug_3d,
        data_parallel=data_parallel,
        device_per_network=one_network_per_device,
        network_parallel=network_parallel,
        resumable=resumable,
        resume_chunk_frames=resume_chunk_frames,
        device=device,
    )


@cli.command(name="projection-file-blend")
@common_command_options
@click.option(
    "--projection-file-path", type=click.Path(exists=True, dir_okay=False),
    required=True, help="Path to the projection file (HDF5).",
)
@click.option(
    "--blend-depth", type=click.IntRange(0, 18), default=10,
    help="Number of style rows that receive the audio blend.",
)
@click.option(
    "--phash-distance", type=click.IntRange(min=0), default=None,
    help="Overlay gate: max eye-crop perceptual hash distance.",
)
@click.option(
    "--bbox-distance", type=click.FloatRange(min=0), default=None,
    help="Overlay gate: max eye bbox center distance in px.",
)
@click.option(
    "--track-length", type=click.IntRange(min=0), default=None,
    help="Overlay gate: min consecutive overlay frames to keep a track.",
)
@click.option(
    "--overlay-detection-side", type=click.IntRange(min=32), default=None,
    help="Run eye DETECTION on frames downscaled to this side (gating still "
    "happens at full resolution). Default: detect at full resolution.",
)
@click.option(
    "--overlay-smoothing", type=click.IntRange(min=0), default=0,
    help="Average the matched eye-box pair over this many trailing frames "
    "before the distance gate and composite (suppresses detector jitter; "
    "history resets on gaps/scene cuts). 0 = off, the reference's exact "
    "per-frame behavior.",
)
def projection_file_blend(  # pylint: disable=too-many-arguments,too-many-locals
    wav: Tuple[str, ...],
    output_path: str,
    networks_directory: Optional[str],
    network_path: Tuple[str, ...],
    networks_json: Optional[str],
    frames_to_visualize: Optional[int],
    output_fps: float,
    output_side_length: int,
    debug_path: Optional[str],
    debug_window: int,
    debug_side_length: int,
    debug_3d: bool,
    alpha: float,
    fft_roll_enabled: bool,
    fft_amplitude_range: Tuple[float, float],
    compute_dtype: Optional[str],
    trace_dir: Optional[str],
    data_parallel: Optional[int],
    one_network_per_device: bool,
    network_parallel: bool,
    dist_coordinator: Optional[str],
    dist_num_processes: Optional[int],
    dist_process_id: Optional[int],
    resumable: bool,
    resume_chunk_frames: int,
    device: str,
    run_config: Optional[str],
    log: Optional[str],
    projection_file_path: str,
    blend_depth: int,
    phash_distance: Optional[int],
    bbox_distance: Optional[float],
    track_length: Optional[int],
    overlay_detection_side: Optional[int],
    overlay_smoothing: int,
) -> None:
    """Blend audio into projection-file latents and synthesize, with optional
    eye-tracking overlay (all three overlay options must be given together)."""
    overlay_params = (phash_distance, bbox_distance, track_length)
    overlay_on = all(p is not None for p in overlay_params)
    if any(p is not None for p in overlay_params) and not overlay_on:
        raise click.UsageError(
            "--phash-distance, --bbox-distance, --track-length must be given together."
        )
    if overlay_detection_side is not None and not overlay_on:
        raise click.UsageError(
            "--overlay-detection-side requires the overlay to be enabled "
            "(--phash-distance, --bbox-distance, --track-length)."
        )
    if overlay_smoothing and not overlay_on:
        raise click.UsageError(
            "--overlay-smoothing requires the overlay to be enabled "
            "(--phash-distance, --bbox-distance, --track-length)."
        )

    setup_log(log)
    maybe_initialize_distributed(dist_coordinator, dist_num_processes, dist_process_id, device)
    network_paths = resolve_networks(networks_directory, network_path, networks_json)
    dump_run_config(run_config, dict(locals()))

    from gance_tpu_torch.pipelines.projection_file_blend import projection_file_blend_api

    projection_file_blend_api(
        wav=[Path(w) for w in wav],
        output_path=Path(output_path),
        network_paths=network_paths,
        frames_to_visualize=frames_to_visualize,
        output_fps=output_fps,
        output_side_length=output_side_length,
        debug_path=Path(debug_path) if debug_path else None,
        debug_window=debug_window,
        debug_side_length=debug_side_length,
        alpha=alpha,
        fft_roll_enabled=fft_roll_enabled,
        fft_amplitude_range=fft_amplitude_range,
        projection_file_path=Path(projection_file_path),
        blend_depth=blend_depth,
        compute_dtype=compute_dtype,
        trace_dir=Path(trace_dir) if trace_dir else None,
        debug_3d=debug_3d,
        data_parallel=data_parallel,
        device_per_network=one_network_per_device,
        network_parallel=network_parallel,
        phash_distance=phash_distance,
        bbox_distance=bbox_distance,
        track_length=track_length,
        overlay_detection_side=overlay_detection_side,
        overlay_smoothing=overlay_smoothing,
        resumable=resumable,
        resume_chunk_frames=resume_chunk_frames,
        device=device,
    )


if __name__ == "__main__":
    cli()
