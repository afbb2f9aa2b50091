"""
noise_blend: WAV(s) -> audio features -> spectrogram-vs-noise alpha blend ->
RMS-driven network selection -> batched synthesis on the device -> video
file with the audio track (the counterpart of gance_tpu/pipelines/noise_blend.py,
on one device).

`resumable=True` checkpoints the render in chunks (media/resume.py): a
killed run resumes at the durable frame count, synthesizing only the frames
after it.

Not ported yet, so they raise NotImplementedError naming their ROADMAP item:
the multi-device placements (`data_parallel`, `device_per_network`,
`network_parallel`) and the debug visualization video (`debug_path`).
"""

import contextlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from gance_tpu_torch.audio.io import read_wavs_scale_for_video
from gance_tpu_torch.media.resume import durable_frames, file_identity, write_source_resumable
from gance_tpu_torch.media.video import write_source_to_disk_forward
from gance_tpu_torch.ops.precision import deterministic_cudnn
from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
from gance_tpu_torch.synthesis.orchestration import resumed_synthesis, vector_synthesis
from gance_tpu_torch.synthesis.runtime import MultiNetwork
from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import timed_iterator, timed_stage, trace

MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"
DEBUG_VIDEO_ITEM = "ROADMAP.md Queue 1 item 13 (debug visualisation, viz/)"


def _compute_dtype(compute_dtype: Optional[str]):
    import torch

    return {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]


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
        synthesized again, and the output equals an unbroken run's (cuDNN's
        deterministic algorithms, `deterministic_cudnn`). Requires
        debug_path=None.
    """
    del debug_window, debug_side_length, debug_3d  # the debug video only
    check_resumable(resumable, debug_path)
    for name, requested in (
        ("data_parallel", data_parallel is not None),
        ("device_per_network", device_per_network),
        ("network_parallel", network_parallel),
    ):
        if requested:
            raise NotImplementedError(f"{name} is not ported yet: {MULTI_DEVICE_ITEM}")
    if debug_path is not None:
        raise NotImplementedError(f"the debug video is not ported yet: {DEBUG_VIDEO_ITEM}")
    device = resolve_device(device)
    audio_paths = [Path(p) for p in wav]
    dtype = _compute_dtype(compute_dtype)
    trace_ctx = trace(Path(trace_dir)) if trace_dir else contextlib.nullcontext()

    # Output scaling runs on the device inside synthesis, so host egress moves
    # output-sized frames.
    with trace_ctx, MultiNetwork(
        network_paths=network_paths,
        output_side_length=output_side_length,
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
            synthesis_output = vector_synthesis(
                networks=multi_networks,
                data=viz_input,
                frames_to_visualize=frames_to_visualize,
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
            render.tick(sum(1 for _ in hero_frames))

    LOGGER.info("noise_blend complete: %s", output_path)
