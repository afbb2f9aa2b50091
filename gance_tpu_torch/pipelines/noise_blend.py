"""
noise_blend: WAV(s) -> audio features -> spectrogram-vs-noise alpha blend ->
RMS-driven network selection -> batched synthesis on the device -> video
file with the audio track (the counterpart of gance_tpu/pipelines/noise_blend.py,
on one device).

`resumable=True` checkpoints the render in chunks (media/resume.py): a
killed run resumes at the durable frame count, synthesizing only the frames
after it.

The placements are JAX's, one at a time (`_resolve_placement`):
`data_parallel` (a ('data', 'model') mesh), `device_per_network` and
`network_parallel`; too few devices degrade loudly to the default. In a
torch.distributed group of several processes the default is pure data
parallelism over every process's devices: each process synthesizes its
share of every batch, every process runs the same frame loop, and only
process 0 writes (`media/video.py::write_source_to_disk_forward`).

`debug_path` also writes the debug video: per frame the hero frame, resized
to `debug_side_length`, beside the synthesis panel (`viz/panels.py`, which
imports matplotlib: only a render with a debug path needs it).
"""

import contextlib
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gance_tpu_torch.audio.io import read_wavs_scale_for_video
from gance_tpu_torch.media.resume import durable_frames, file_identity, write_source_resumable
from gance_tpu_torch.media.video import resize_source, write_source_to_disk_forward
from gance_tpu_torch.ops.precision import deterministic_cudnn
from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
from gance_tpu_torch.synthesis.orchestration import resumed_synthesis, vector_synthesis
from gance_tpu_torch.synthesis.runtime import MultiNetwork
from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import timed_iterator, timed_stage, trace

def _compute_dtype(compute_dtype: Optional[str]):
    import torch

    return {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]


def _device_count(device: Device) -> int:
    """Every process's devices: JAX's len(jax.devices())."""
    from gance_tpu_torch.parallel.mesh import global_devices

    return len(global_devices(device=device))


def _build_mesh(data_parallel: Optional[int], device: Device = "cuda"):
    """('data', 'model') mesh for multi-device synthesis, or None for one device."""
    if data_parallel is None:
        return None
    from gance_tpu_torch.parallel.mesh import create_mesh

    if _device_count(device) < 2:
        LOGGER.warning(
            "--data-parallel requested but only one device is visible; "
            "running single-device."
        )
        return None
    return create_mesh(data_parallel=data_parallel, device=device)


def _check_network_parallel(requested: bool, network_paths: List[Path],
                            device: Device = "cuda") -> bool:
    """Network-parallel synthesis needs >= one device per network; degrade loudly."""
    if not requested:
        return False
    count = _device_count(device)
    if count < len(network_paths):
        LOGGER.warning(
            "--network-parallel requested but %d networks > %d devices; "
            "running the default resident-network path.",
            len(network_paths), count,
        )
        return False
    return True


def _resolve_placement(
    data_parallel: Optional[int],
    device_per_network: bool,
    network_parallel: bool,
    network_paths: List[Path],
    device: Device = "cuda",
):
    """
    One placement flag at a time: conflicting flags raise (the CLI promises
    mutual exclusion). Too few devices degrade loudly to the default
    resident-network path. In a group of several processes with no flag,
    pure data parallelism over every process's devices.
    :return: (mesh or None, device_per_network, network_parallel)
    """
    if sum([data_parallel is not None, device_per_network, network_parallel]) > 1:
        raise ValueError(
            "--data-parallel, --one-network-per-device, and --network-parallel "
            "are mutually exclusive"
        )
    from gance_tpu_torch.parallel.mesh import create_mesh, process_group_info

    if (data_parallel is None and not device_per_network and not network_parallel
            and process_group_info()[1] > 1):
        LOGGER.info(
            "Multi-process render: defaulting to pure data parallelism over all "
            "%d devices of the group.", _device_count(device),
        )
        return create_mesh(device=device), False, False
    mesh = _build_mesh(data_parallel, device)
    return mesh, device_per_network, _check_network_parallel(network_parallel, network_paths,
                                                             device)


def write_debug_video(
    tiles: Sequence[Optional[Iterator[np.ndarray]]],
    debug_path: Path,
    video_fps: float,
    audio_paths: List[Path],
) -> Iterator[np.ndarray]:
    """The debug video: per frame, the frames of `tiles` side by side (a None
    tile is left out), written to `debug_path` with the audio as the stream
    is drawn; yields each frame as it is written."""
    from gance_tpu_torch.media.images import horizontal_concat_images

    return write_source_to_disk_forward(
        source=(horizontal_concat_images(frames)
                for frames in zip(*[tile for tile in tiles if tile is not None])),
        video_path=Path(debug_path),
        video_fps=video_fps,
        audio_paths=audio_paths,
    )


def check_resumable(resumable: bool, debug_path: Optional[Path]) -> None:
    """A resumable render has no debug video, and runs in one process: under a
    torch.distributed group of several, every process would race the same
    manifest (gance_tpu refuses jax.process_count() > 1 the same way)."""
    if not resumable:
        return
    if debug_path is not None:
        raise ValueError("--resumable does not support the debug visualization video")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError(
            "--resumable is single-process only; combine it with "
            "single-host rendering or drop --dist-*"
        )


def noise_blend_api(
    wav: List[Path],
    output_path: Path,
    network_paths: List[Path],
    frames_to_visualize: Optional[int],
    output_fps: float,
    output_side_length: int,
    debug_path: Optional[Path],
    debug_window: Optional[int],
    debug_side_length: Optional[int],
    alpha: float,
    fft_roll_enabled: bool,
    fft_amplitude_range: Tuple[float, float],
    cache_path: Optional[Path] = None,
    compute_dtype: Optional[str] = None,
    trace_dir: Optional[Path] = None,
    debug_3d: bool = False,
    data_parallel: Optional[int] = None,
    device_per_network: bool = False,
    network_parallel: bool = False,
    resumable: bool = False,
    resume_chunk_frames: int = 300,
    device: Device = "cuda",
) -> None:
    """
    Render a music video: audio features alpha-blended with smoothed gaussian
    noise, the network of each frame selected by quantized RMS loudness. The
    audio DSP and the synthesis run on `device` ("cuda" by default; raises on
    a host without CUDA). The video keeps the WAVs' audio track.

    :param compute_dtype: "float32" or "bfloat16"; None takes
        GANCE_TPU_COMPUTE_DTYPE (the runtime's default).
    :param trace_dir: write a torch.profiler Chrome trace of the run here.
    :param resumable: checkpoint the render every `resume_chunk_frames`
        frames (media/resume.py). A killed run resumes from the durable frame
        count: the inputs are sliced there (at the stream window at or
        before it, `resumed_synthesis`), so finished frames are not
        synthesized again, and the output equals an unbroken run's: fp32
        synthesis repeats itself bit for bit (each `Conv0_up` runs as
        forward phase convolutions), and the render runs under
        `deterministic_cudnn`, which costs its synthesis nothing. Requires
        debug_path=None.
    :param debug_path: also write the debug video here: per frame the hero
        frame resized to `debug_side_length` beside the synthesis panel of
        that side, with the 3D waterfall of the whole stream when `debug_3d`.
        gance_tpu's noise-blend video has no windowed tile, so
        `debug_window` is not read.
    """
    del debug_window  # gance_tpu's noise-blend debug video reads no window either
    check_resumable(resumable, debug_path)
    device = resolve_device(device)
    mesh, device_per_network, network_parallel = _resolve_placement(
        data_parallel, device_per_network, network_parallel, network_paths, device)
    audio_paths = [Path(p) for p in wav]
    dtype = _compute_dtype(compute_dtype)
    trace_ctx = trace(Path(trace_dir)) if trace_dir else contextlib.nullcontext()

    # Output scaling runs on the device inside synthesis, so host egress moves
    # output-sized frames.
    with trace_ctx, MultiNetwork(
        network_paths=network_paths,
        output_side_length=output_side_length,
        mesh=mesh,
        device_per_network=device_per_network,
        network_parallel=network_parallel,
        device=device,
        **({"compute_dtype": dtype} if dtype is not None else {}),
    ) as multi_networks:
        with timed_stage("audio_features") as features:
            audio = read_wavs_scale_for_video(
                wavs=audio_paths,
                vector_length=multi_networks.expected_vector_length,
                frames_per_second=output_fps,
                cache_path=cache_path,
            ).wav_data
            viz_input = alpha_blend_vectors_max_rms_power_audio(
                alpha=alpha,
                fft_roll_enabled=fft_roll_enabled,
                fft_amplitude_range=fft_amplitude_range,
                time_series_audio_vectors=audio,
                vector_length=multi_networks.expected_vector_length,
                network_indices=multi_networks.network_indices,
                device=device,
            )
            features.tick(len(viz_input.network_indices.result.data))

        # "render": synthesis and the write together, from the first dispatch
        # to the finished file
        with timed_stage("render") as render:
            if resumable:
                total = len(np.asarray(viz_input.network_indices.result.data))
                if frames_to_visualize is not None:
                    total = min(total, frames_to_visualize)
                fingerprint = {
                    "pipeline": "noise_blend",
                    "wavs": [file_identity(p) for p in audio_paths],
                    "networks": [file_identity(p) for p in network_paths],
                    "alpha": alpha,
                    "fft_roll_enabled": bool(fft_roll_enabled),
                    "fft_amplitude_range": list(fft_amplitude_range),
                    "output_fps": float(output_fps),
                    "output_side_length": int(output_side_length),
                    "frames_to_visualize": frames_to_visualize,
                    "compute_dtype": compute_dtype,
                }
                start = durable_frames(Path(output_path), fingerprint)
                if start:
                    LOGGER.info("Resuming noise_blend at frame %d/%d", start, total)
                with deterministic_cudnn():  # frames that repeat from run to run
                    render.tick(write_source_resumable(
                        source=resumed_synthesis(multi_networks, viz_input, start, total),
                        output_path=Path(output_path),
                        video_fps=output_fps,
                        fingerprint=fingerprint,
                        audio_paths=audio_paths,
                        chunk_frames=resume_chunk_frames,
                    ) - start)
                LOGGER.info("noise_blend complete: %s", output_path)
                return
            visualizer = None
            if debug_path is not None:
                from gance_tpu_torch.viz.panels import synthesis_visualizer

                visualizer = synthesis_visualizer(
                    side_length=debug_side_length,
                    waterfall_vectors=viz_input.combined if debug_3d else None,
                )
            synthesis_output = vector_synthesis(
                networks=multi_networks,
                data=viz_input,
                frames_to_visualize=frames_to_visualize,
                visualizer=visualizer,
            )
            hero_frames = timed_iterator(
                "encode",
                write_source_to_disk_forward(
                    source=synthesis_output.synthesized_images,  # already output-sized
                    video_path=Path(output_path),
                    video_fps=output_fps,
                    audio_paths=audio_paths,
                    high_quality=True,
                ),
            )
            if debug_path is not None:
                hero_frames = write_debug_video(
                    [resize_source(hero_frames, (debug_side_length, debug_side_length)),
                     synthesis_output.visualization_images],
                    debug_path, output_fps, audio_paths,
                )
            render.tick(sum(1 for _ in hero_frames))

    LOGGER.info("noise_blend complete: %s", output_path)
