"""
projection_file_blend, the flagship pipeline (the counterpart of
gance_tpu/pipelines/projection_file_blend.py, on one device).

A projection file's final latents get the audio spectrogram alpha-blended
into their first `blend_depth` style rows; batched synthesis on the device
with loudness-driven network switching; frames and targets cubic-scaled on
the host; an optional eye-tracked overlay of the projection targets, gated by
bbox and pHash distance, track length and (optionally) a music-complexity
mask; the video written with the audio track.

Not ported yet, so they raise NotImplementedError naming their ROADMAP item:
the multi-device placements (`data_parallel`, `device_per_network`,
`network_parallel`), the debug visualization video (`debug_path`) and
resumable renders (`resumable`).
"""

import contextlib
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gance_tpu_torch.audio import reduction as vector_reduction
from gance_tpu_torch.audio.io import read_wavs_scale_for_video
from gance_tpu_torch.media.disk_tee import NPY_SERIALIZER, iterator_on_disk
from gance_tpu_torch.media.video import (
    scale_square_source_duplicate,
    write_source_to_disk_forward,
)
from gance_tpu_torch.overlay.common import write_boxes_onto_image
from gance_tpu_torch.overlay.eye_tracking import compute_eye_tracking_overlay
from gance_tpu_torch.pipelines.noise_blend import (
    DEBUG_VIDEO_ITEM,
    MULTI_DEVICE_ITEM,
    RESUME_ITEM,
    _compute_dtype,
)
from gance_tpu_torch.projection.file_reader import (
    final_latents_matrices_label,
    load_projection_file,
)
from gance_tpu_torch.synthesis.inputs import alpha_blend_projection_file
from gance_tpu_torch.synthesis.orchestration import vector_synthesis
from gance_tpu_torch.synthesis.runtime import MultiNetwork
from gance_tpu_torch.types import underlying_length
from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.divisor import divide_no_remainder
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import timed_iterator, timed_stage, trace


def projection_file_blend_api(  # pylint: disable=too-many-arguments,too-many-locals
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
    projection_file_path: Path,
    blend_depth: int,
    compute_dtype: Optional[str] = None,
    trace_dir: Optional[Path] = None,
    debug_3d: bool = False,
    data_parallel: Optional[int] = None,
    device_per_network: bool = False,
    network_parallel: bool = False,
    complexity_change_rolling_sum_window: Optional[int] = None,
    complexity_change_threshold: Optional[float] = None,
    phash_distance: Optional[int] = None,
    bbox_distance: Optional[float] = None,
    track_length: Optional[int] = None,
    overlay_detection_side: Optional[int] = None,
    overlay_smoothing: int = 0,
    resumable: bool = False,
    resume_chunk_frames: int = 300,
    device: Device = "cuda",
) -> None:
    """
    Render a music video from a projection file (see the module docstring);
    parameter meanings match the JAX package's. Synthesis, the audio DSP and
    the overlay's pHash run on `device` ("cuda" by default; raises on a host
    without CUDA). The overlay is on when `phash_distance`, `bbox_distance`
    and `track_length` are all given.

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
    overlay_enabled = all(p is not None for p in (phash_distance, bbox_distance, track_length))
    music_mask_enabled = all(
        p is not None
        for p in (complexity_change_rolling_sum_window, complexity_change_threshold)
    )
    if music_mask_enabled and not overlay_enabled:
        raise ValueError("Overlay music mask without overlay being enabled is not supported!")
    device = resolve_device(device)
    trace_ctx = trace(Path(trace_dir)) if trace_dir else contextlib.nullcontext()

    with trace_ctx, load_projection_file(Path(projection_file_path)) as reader:
        _blend_from_reader(
            reader=reader,
            wav=wav,
            output_path=output_path,
            network_paths=network_paths,
            frames_to_visualize=frames_to_visualize,
            output_fps=output_fps,
            output_side_length=output_side_length,
            alpha=alpha,
            fft_roll_enabled=fft_roll_enabled,
            fft_amplitude_range=fft_amplitude_range,
            blend_depth=blend_depth,
            compute_dtype=compute_dtype,
            complexity_change_rolling_sum_window=(
                complexity_change_rolling_sum_window if music_mask_enabled else None
            ),
            complexity_change_threshold=complexity_change_threshold,
            overlay_gates=(
                (phash_distance, bbox_distance, track_length) if overlay_enabled else None
            ),
            overlay_detection_side=overlay_detection_side,
            overlay_smoothing=overlay_smoothing,
            device=device,
        )
    LOGGER.info("projection_file_blend complete: %s", output_path)


def _blend_from_reader(  # pylint: disable=too-many-arguments,too-many-locals
    *,
    reader,
    wav: List[Path],
    output_path: Path,
    network_paths: List[Path],
    frames_to_visualize: Optional[int],
    output_fps: float,
    output_side_length: int,
    alpha: float,
    fft_roll_enabled: bool,
    fft_amplitude_range: Tuple[float, float],
    blend_depth: int,
    compute_dtype: Optional[str],
    complexity_change_rolling_sum_window: Optional[int],
    complexity_change_threshold: Optional[float],
    overlay_gates: Optional[Tuple[int, float, int]],
    overlay_detection_side: Optional[int],
    overlay_smoothing: int,
    device: Device,
) -> None:
    """
    The render over an open projection file. `reader` needs only
    `projection_attributes` and the lazy `final_latents` and `target_images`
    (each access a fresh iterator), so a caller without h5py can hand in an
    in-memory stand-in. `overlay_gates` is (phash, bbox distance, track
    length), or None for no overlay; a rolling-sum window turns the
    music-complexity mask on.
    """
    audio_paths = [Path(p) for p in wav]
    dtype = _compute_dtype(compute_dtype)
    # No output_side_length: synthesized frames leave the device at the
    # network's size and are cubic-scaled on the host, as the targets are.
    with MultiNetwork(
        network_paths=network_paths,
        device=device,
        **({"compute_dtype": dtype} if dtype is not None else {}),
    ) as multi_networks:
        vector_length = multi_networks.expected_vector_length
        final_latents = final_latents_matrices_label(reader)
        final_latents_in_file = underlying_length(final_latents.data) / vector_length
        attributes = reader.projection_attributes
        LOGGER.info(
            "Reading projection file. Complete: %s, Final Latent Count: %s, "
            "Processed Frames: %s",
            attributes.complete,
            final_latents_in_file,
            attributes.projection_frame_count,
        )
        if (
            not attributes.complete
            or abs(final_latents_in_file - attributes.projection_frame_count) > 2
        ):
            raise ValueError("Invalid Projection File, cannot continue.")
        frame_multiplier = divide_no_remainder(
            numerator=int(output_fps), denominator=int(attributes.projection_fps)
        )
        num_output_frames = int(frame_multiplier * final_latents_in_file)

        with timed_stage("audio_features") as features:
            time_series_audio_vectors = read_wavs_scale_for_video(
                wavs=audio_paths,
                vector_length=vector_length,
                target_num_vectors=num_output_frames,
            ).wav_data
            viz_input = alpha_blend_projection_file(
                final_latents_matrices_label=final_latents,
                alpha=alpha,
                fft_roll_enabled=fft_roll_enabled,
                fft_amplitude_range=fft_amplitude_range,
                blend_depth=blend_depth,
                time_series_audio_vectors=time_series_audio_vectors,
                vector_length=vector_length,
                network_indices=multi_networks.network_indices,
                device=device,
            )
            features.tick(num_output_frames)

        # "render": synthesis, the overlay and the write together, from the
        # first dispatch to the finished file
        with timed_stage("render") as render:
            synthesis_output = vector_synthesis(
                networks=multi_networks,
                data=viz_input,
                frames_to_visualize=frames_to_visualize,
                unload_networks_when_complete=True,
            )
            backgrounds = timed_iterator(
                "synth_egress",
                scale_square_source_duplicate(
                    source=synthesis_output.synthesized_images,
                    output_side_length=output_side_length,
                ),
            )
            if overlay_gates is None:
                blended: Iterator[np.ndarray] = backgrounds
            else:
                blended = _overlay(
                    foregrounds=timed_iterator(
                        "target_read",
                        scale_square_source_duplicate(
                            source=reader.target_images,
                            output_side_length=output_side_length,
                            frame_multiplier=frame_multiplier,
                        ),
                    ),
                    backgrounds=backgrounds,
                    gates=overlay_gates,
                    skip_mask=_skip_mask(
                        time_series_audio_vectors,
                        vector_length,
                        num_output_frames,
                        complexity_change_rolling_sum_window,
                        complexity_change_threshold,
                        device,
                    ),
                    detection_side=overlay_detection_side,
                    smoothing=overlay_smoothing,
                    device=device,
                )
            written = timed_iterator(
                "encode",
                write_source_to_disk_forward(
                    source=timed_iterator("compose", blended),
                    video_path=Path(output_path),
                    video_fps=output_fps,
                    audio_paths=audio_paths,
                    high_quality=True,
                ),
            )
            render.tick(sum(1 for _ in written))


def _skip_mask(
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    num_output_frames: int,
    rolling_sum_window: Optional[int],
    threshold: Optional[float],
    device: Device,
) -> List[bool]:
    """Frames on which the overlay is skipped: where the music's complexity
    changes faster than `threshold` (NaN, the rolling sum's warm-up, counts
    as infinitely fast); none without a rolling-sum window."""
    if rolling_sum_window is None:
        return [False] * num_output_frames
    mask = vector_reduction.music_complexity_mask(
        time_series_audio_vectors=time_series_audio_vectors,
        vector_length=vector_length,
        rolling_sum_window=rolling_sum_window,
        device=device,
    )
    mask_data = np.asarray(mask.result.data, dtype=float)
    mask_data = np.where(np.isnan(mask_data), np.inf, mask_data)
    return list(mask_data > threshold)


def _overlay(
    foregrounds: Iterator[np.ndarray],
    backgrounds: Iterator[np.ndarray],
    gates: Tuple[int, float, int],
    skip_mask: List[bool],
    detection_side: Optional[int],
    smoothing: int,
    device: Device,
) -> Iterator[np.ndarray]:
    """The eye-tracked composite. Both streams are disk-teed (NPY): detection
    reads them here, and every decision is materialized (the track-length
    filter needs them all) before the returned stream replays the copies to
    composite."""
    phash_distance, bbox_distance, track_length = gates
    foreground_copies = iterator_on_disk(iterator=foregrounds, copies=1, serializer=NPY_SERIALIZER)
    background_copies = iterator_on_disk(iterator=backgrounds, copies=1, serializer=NPY_SERIALIZER)
    overlay_results = compute_eye_tracking_overlay(
        foreground_images=foreground_copies[0],
        background_images=background_copies[0],
        min_phash_distance=phash_distance,
        min_bbox_distance=bbox_distance,
        skip_mask=skip_mask,
        detection_side=detection_side,
        temporal_smoothing=smoothing,
        want_contexts=False,
        device=device,
    )
    LOGGER.info("Starting to compute mask to filter out short sequences of overlay frames.")
    boxes_list = list(timed_iterator("detect", overlay_results.bbox_lists))
    long_tracks_mask = vector_reduction.track_length_filter(
        bool_tracks=np.asarray(
            [(not skip) and (box is not None) for skip, box in zip(skip_mask, boxes_list)]
        ),
        track_length=track_length,
    )

    def compose() -> Iterator[np.ndarray]:
        try:
            for bounding_boxes, foreground, background, in_long_track in zip(
                boxes_list, foreground_copies[1], background_copies[1], long_tracks_mask
            ):
                yield (
                    write_boxes_onto_image(
                        foreground_image=foreground,
                        background_image=background,
                        bounding_boxes=bounding_boxes,
                    )
                    if in_long_track
                    else background
                )
        finally:  # zip stops short of the copies' ends: close them, so the tees clean up
            for stream in foreground_copies + background_copies:
                stream.close()

    return compose()
