"""
CLI: music -> StyleGAN2 music video with the port (the counterpart of
gance_tpu/cli/music_into_networks.py, with the same option names plus
--device).

    python -m gance_tpu_torch.cli.music_into_networks noise-blend \
        --wav song.wav --output-path video.avi --networks-directory nets \
        --output-fps 30 --output-side-length 1024 [--device cuda]

`noise-blend` runs on one device. `projection-file-blend` is not registered
yet (ROADMAP.md Queue 1 item 6).
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
    maybe_initialize_distributed(dist_coordinator, dist_num_processes, dist_process_id)
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


if __name__ == "__main__":
    cli()
