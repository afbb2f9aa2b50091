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

Projection runs on one device: --data-parallel and --dist-* wait for ROADMAP.md
Queue 1 item 12 (multi-device), `visualize-final-latents` for item 13 (viz),
and each raises a usage error naming its item.
"""

from pathlib import Path
from typing import Callable, Optional, Tuple

import click

from gance_tpu_torch.utils.logging import add_log_file

_MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"


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
            help=f"Not ported yet ({_MULTI_DEVICE_ITEM}); raises.",
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
            help=f"Not ported yet ({_MULTI_DEVICE_ITEM}); raises.",
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


def _refuse_multi_device(kwargs: dict) -> None:
    """Consume --data-parallel and --dist-*; any of them given raises."""
    given = [name for name in ("data_parallel", "dist_coordinator", "dist_num_processes",
                               "dist_process_id") if kwargs.pop(name) is not None]
    if given:
        flags = ", ".join("--" + name.replace("_", "-") for name in given)
        raise click.UsageError(f"{flags}: multi-device projection is not ported yet "
                               f"({_MULTI_DEVICE_ITEM})")


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
    vgg_weights: Optional[str] = None,
    warm_start: bool = False,
    convergence_stop: Optional[float] = None,
    convergence_window: int = 50,
    batch_number: Optional[int] = None,
    device: str = "cuda",
) -> None:
    from gance_tpu_torch.projection.file_writer import project_video_to_file

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
    _refuse_multi_device(kwargs)
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
    _refuse_multi_device(kwargs)
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
    """Render [latents plot | target | final image] triptych video from a file
    (not ported yet: ROADMAP.md Queue 1 item 13, viz)."""
    raise click.UsageError(
        "visualize-final-latents is not ported yet: it needs the viz panels "
        "(ROADMAP.md Queue 1 item 13, debug visualisation)"
    )


if __name__ == "__main__":
    cli()
