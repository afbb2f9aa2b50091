"""
CLI: project videos into a network's latent space -> projection files, with
the port (the counterpart of gance_tpu/cli/project_video_to_file.py, with the
same commands and option names plus --device).

    python -m gance_tpu_torch.cli.project_video_to_file videos \
        --path-to-network net.pkl --steps-per-projection 1000 \
        --video-output source.mp4 projection.hdf5 [--device cuda]
    python -m gance_tpu_torch.cli.project_video_to_file directory \
        --path-to-network net.pkl --directory-of-videos videos \
        --output-file-directory projections [--device cuda]

`--data-parallel N` projects each batch's frames data-parallel over a
('data', 'model') mesh (the batch is raised to fill the data axis);
`--dist-coordinator host:port --dist-num-processes P --dist-process-id i`
joins P processes, which default to pure data parallelism over every
process's devices, with only process 0 writing the projection file.

    python -m gance_tpu_torch.cli.project_video_to_file visualize-final-latents \
        --projection-file projection.hdf5 --output-path triptych.mp4

renders the [final latents plot | target | final image] triptych of a file
on the host (matplotlib; no network, no device).
"""

from pathlib import Path
from typing import Callable, Optional, Tuple

import click

from gance_tpu_torch.utils.logging import add_log_file

def projection_options(func: Callable) -> Callable:
    """Shared projection options (the JAX CLI's, reference :165-270)."""
    options = [
        click.option("--video-fps", type=click.FloatRange(min=0), default=None),
        click.option(
            "--path-to-network", type=click.Path(exists=True, dir_okay=False),
            required=True,
        ),
        click.option("--projection-width-height", type=(int, int), default=None),
        click.option("--projection-fps", type=click.FloatRange(min=0), default=None),
        click.option("--steps-per-projection", type=click.IntRange(min=1), default=1000),
        click.option(
            "--compute-dtype", type=click.Choice(["float32", "bfloat16"]),
            default=None,
            help="Synthesis dtype inside the projection loss: float32 (exact, "
            "default) or bfloat16 (faster steps; latents/Adam stay fp32).",
        ),
        click.option("--num-frames-to-project", type=click.IntRange(min=1), default=None),
        click.option(
            "--projection-batch", type=click.IntRange(min=1), default=1,
            help="Project this many frames per optimization step (each frame "
            "keeps independent latents/noises).",
        ),
        click.option(
            "--data-parallel", type=click.IntRange(min=1), default=None,
            help="Data-parallelize each projection batch's frames over a "
            "('data','model') device mesh with this data-axis size. Use with "
            "--projection-batch >= data-parallel size.",
        ),
        click.option(
            "--warm-start", is_flag=True, default=False,
            help="EXPERIMENTAL: initialize each projection batch's latents "
            "(jitter-free) from the previous batch's finals. Default: "
            "cold-start per frame, the reference's behavior.",
        ),
        click.option(
            "--convergence-stop", type=click.FloatRange(min=0), default=None,
            help="Stop each frame's optimization early once the per-step "
            "distance trace plateaus: when the relative improvement between "
            "the two most recent --convergence-window step blocks falls below "
            "this value for every frame in the batch. Default: off (run the "
            "full --steps-per-projection).",
        ),
        click.option(
            "--convergence-window", type=click.IntRange(min=2), default=50,
            help="Block size (steps) for the --convergence-stop plateau "
            "check; also the stop granularity of the segmented loop.",
        ),
        click.option(
            "--vgg-weights", type=click.Path(exists=True, dir_okay=False),
            default=None,
            help="Pretrained perceptual weights: the NVlabs "
            "vgg16_zhang_perceptual.pkl or an imported .npz. Default: "
            "deterministic random-VGG fallback metric.",
        ),
        # latents histories default ON (reference project_video_to_file.py:236);
        # the heavyweight image/noise histories default OFF like the reference.
        click.option(
            "--latents-histories-enabled/--latents-histories-disabled", default=True
        ),
        click.option("--noises-histories-enabled", is_flag=True, default=False),
        click.option("--images-histories-enabled", is_flag=True, default=False),
        click.option(
            "--dist-coordinator", type=str, default=None,
            help="host:port of process 0. Setting this (with the two options "
            "below) joins a multi-process projection: every process runs the "
            "same command with its own --dist-process-id, the mesh spans all "
            "processes' devices, and only process 0 writes the projection file.",
        ),
        click.option("--dist-num-processes", type=int, default=None),
        click.option("--dist-process-id", type=int, default=None),
        click.option(
            "--device", type=str, default="cuda", show_default=True,
            help="torch device to project on (cuda, cuda:N or cpu).",
        ),
        click.option("--log", type=click.Path(dir_okay=False), default=None),
    ]
    for option in reversed(options):
        func = option(func)
    return func


def _pop_distributed_options(kwargs: dict) -> None:
    """Consume the --dist-* options and, when given, join the process group
    (before any mesh or projector is built)."""
    from gance_tpu_torch.cli.common import maybe_initialize_distributed

    maybe_initialize_distributed(kwargs.pop("dist_coordinator"),
                                 kwargs.pop("dist_num_processes"),
                                 kwargs.pop("dist_process_id"), kwargs["device"])


@click.group()
def cli() -> None:
    """Project videos into the latent space of networks, creating projection files."""
    from gance_tpu_torch.utils.profiling import start_memwatch

    start_memwatch()  # no-op unless GANCE_TPU_MEMWATCH is set


def _run_projection(
    video_path: Path,
    output_path: Path,
    path_to_network: str,
    video_fps: Optional[float],
    projection_width_height: Optional[Tuple[int, int]],
    projection_fps: Optional[float],
    steps_per_projection: int,
    num_frames_to_project: Optional[int],
    latents_histories_enabled: bool,
    noises_histories_enabled: bool,
    images_histories_enabled: bool,
    compute_dtype: Optional[str] = None,
    projection_batch: int = 1,
    data_parallel: Optional[int] = None,
    vgg_weights: Optional[str] = None,
    warm_start: bool = False,
    convergence_stop: Optional[float] = None,
    convergence_window: int = 50,
    batch_number: Optional[int] = None,
    device: str = "cuda",
) -> None:
    from gance_tpu_torch.parallel.mesh import create_mesh, process_group_info
    from gance_tpu_torch.projection.file_writer import project_video_to_file

    mesh = None
    if data_parallel is not None:
        mesh = create_mesh(data_parallel=data_parallel, device=device)
    elif process_group_info()[1] > 1:
        # several processes with no mesh would each project the whole batch:
        # default to pure data parallelism over every process's devices
        mesh = create_mesh(device=device)

    project_video_to_file(
        path_to_video=video_path,
        path_to_network=Path(path_to_network),
        projection_file_path=output_path,
        video_fps=video_fps,
        projection_fps=projection_fps,
        projection_width_height=projection_width_height,
        steps_per_projection=steps_per_projection,
        num_frames_to_project=num_frames_to_project,
        latents_histories_enabled=latents_histories_enabled,
        noises_histories_enabled=noises_histories_enabled,
        images_histories_enabled=images_histories_enabled,
        compute_dtype=compute_dtype,
        projection_batch=projection_batch,
        mesh=mesh,
        vgg_weights_path=Path(vgg_weights) if vgg_weights else None,
        warm_start=warm_start,
        convergence_stop=convergence_stop,
        convergence_window=convergence_window,
        batch_number=batch_number,
        device=device,
    )


@cli.command()
@projection_options
@click.option(
    "--video-output", type=(click.Path(exists=True, dir_okay=False), click.Path(dir_okay=False)),
    multiple=True, required=True,
    help="(input video, output projection file) pair; repeatable.",
)
def videos(video_output: Tuple[Tuple[str, str], ...], log: Optional[str], **kwargs) -> None:
    """Project one or more (video, output) pairs."""
    add_log_file(Path(log) if log else None)
    _pop_distributed_options(kwargs)
    for batch_number, (video_path, output_path) in enumerate(video_output):
        _run_projection(
            Path(video_path), Path(output_path), batch_number=batch_number, **kwargs
        )


@cli.command()
@projection_options
@click.option(
    "--directory-of-videos", type=click.Path(exists=True, file_okay=False), required=True
)
@click.option("--video-extension", type=str, default=".mp4")
@click.option(
    "--output-file-directory", type=click.Path(file_okay=False), required=True
)
@click.option("--output-file-prefix", type=str, default="projection")
def directory(
    directory_of_videos: str,
    video_extension: str,
    output_file_directory: str,
    output_file_prefix: str,
    log: Optional[str],
    **kwargs,
) -> None:
    """Project every video in a directory."""
    add_log_file(Path(log) if log else None)
    _pop_distributed_options(kwargs)
    out_dir = Path(output_file_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(Path(directory_of_videos).glob(f"*{video_extension}"))
    if not sources:
        raise click.UsageError(
            f"No {video_extension} videos in {directory_of_videos}"
        )
    for batch_number, video_path in enumerate(sources):
        output_path = out_dir / f"{output_file_prefix}_{video_path.stem}.hdf5"
        _run_projection(video_path, output_path, batch_number=batch_number, **kwargs)


@cli.command(name="visualize-final-latents")
@click.option(
    "--projection-file", type=click.Path(exists=True, dir_okay=False), required=True
)
@click.option("--output-path", type=click.Path(dir_okay=False), required=True)
@click.option("--audio-path", type=click.Path(exists=True, dir_okay=False), multiple=True)
@click.option("--video-height", type=click.IntRange(min=1), default=400)
@click.option("--log", type=click.Path(dir_okay=False), default=None)
def visualize_final_latents_command(
    projection_file: str,
    output_path: str,
    audio_path: Tuple[str, ...],
    video_height: int,
    log: Optional[str],
) -> None:
    """Render [latents plot | target | final image] triptych video from a file."""
    add_log_file(Path(log) if log else None)
    from gance_tpu_torch.projection.visualization import visualize_final_latents

    visualize_final_latents(
        projection_file_path=Path(projection_file),
        output_video_path=Path(output_path),
        audio_paths=[Path(p) for p in audio_path] or None,
        video_height=video_height,
    )


if __name__ == "__main__":
    cli()
