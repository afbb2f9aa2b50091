"""
noise_blend: WAV(s) -> audio features -> spectrogram-vs-noise alpha blend ->
RMS-driven network selection -> batched synthesis on the device -> video
file with the audio track (the counterpart of gance_tpu/pipelines/noise_blend.py,
on one device).

Not ported yet, so they raise NotImplementedError naming their ROADMAP item:
the multi-device placements (`data_parallel`, `device_per_network`,
`network_parallel`), the debug visualization video (`debug_path`) and
resumable renders (`resumable`).
"""

import contextlib
from pathlib import Path
from typing import List, Optional, Tuple

from gance_tpu_torch.audio.io import read_wavs_scale_for_video
from gance_tpu_torch.media.video import write_source_to_disk_forward
from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
from gance_tpu_torch.synthesis.orchestration import vector_synthesis
from gance_tpu_torch.synthesis.runtime import MultiNetwork
from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import timed_iterator, timed_stage, trace

MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"
DEBUG_VIDEO_ITEM = "ROADMAP.md Queue 1 item 13 (debug visualisation, viz/)"
RESUME_ITEM = "ROADMAP.md Queue 1 item 2 (media/resume.py)"


def _compute_dtype(compute_dtype: Optional[str]):
    import torch

    return {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]


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
    """
    del debug_window, debug_side_length, debug_3d, resume_chunk_frames  # debug/resume only
    for name, requested in (
        ("data_parallel", data_parallel is not None),
        ("device_per_network", device_per_network),
        ("network_parallel", network_parallel),
    ):
        if requested:
            raise NotImplementedError(f"{name} is not ported yet: {MULTI_DEVICE_ITEM}")
    if debug_path is not None:
        raise NotImplementedError(f"the debug video is not ported yet: {DEBUG_VIDEO_ITEM}")
    if resumable:
        raise NotImplementedError(f"resumable renders are not ported yet: {RESUME_ITEM}")
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
