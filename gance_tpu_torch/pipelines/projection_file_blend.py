"""
projection_file_blend, the flagship pipeline (the counterpart of
gance_tpu/pipelines/projection_file_blend.py, on one device).

A projection file's final latents get the audio spectrogram alpha-blended
into their first `blend_depth` style rows; batched synthesis on the device
with loudness-driven network switching; frames and targets cubic-scaled on
the host; an optional eye-tracked overlay of the projection targets, gated by
bbox and pHash distance, track length and (optionally) a music-complexity
mask; the video written with the audio track.

`resumable=True` checkpoints the hero frames in chunks (media/resume.py) and
each overlay decision in a JSON-lines sidecar as it is made: a killed run
resumes synthesis at the durable frame count and detection at the decided
frame count.

The placements (`data_parallel`, `device_per_network`, `network_parallel`,
and pure data parallelism across processes) are noise_blend's
`_resolve_placement`; only process 0 writes. `debug_path` also writes the
debug video (`_debug_tiles`): the blended frame, the foreground, the file's
final image, the synthesis panel, the overlay panel and the music-mask panel,
each `debug_side_length` square (the panels import matplotlib: only a render
with a debug path needs it).
"""

import contextlib
import json
import os
import time
from itertools import islice, tee
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gance_tpu_torch.audio import reduction as vector_reduction
from gance_tpu_torch.audio.io import read_wavs_scale_for_video
from gance_tpu_torch.media.disk_tee import NPY_SERIALIZER, iterator_on_disk
from gance_tpu_torch.media.resume import durable_frames, file_identity, write_source_resumable
from gance_tpu_torch.media.video import (
    scale_square_source_duplicate,
    write_source_to_disk_forward,
)
from gance_tpu_torch.ops.precision import deterministic_cudnn
from gance_tpu_torch.overlay.common import write_boxes_onto_image
from gance_tpu_torch.overlay.eye_tracking import compute_eye_tracking_overlay
from gance_tpu_torch.pipelines.noise_blend import (
    _compute_dtype,
    _resolve_placement,
    check_resumable,
    write_debug_video,
)
from gance_tpu_torch.projection.file_reader import (
    final_latents_matrices_label,
    load_projection_file,
)
from gance_tpu_torch.synthesis.inputs import alpha_blend_projection_file
from gance_tpu_torch.synthesis.orchestration import resumed_synthesis, vector_synthesis
from gance_tpu_torch.synthesis.runtime import MultiNetwork
from gance_tpu_torch.types import BoundingBox, ResultLayers, underlying_length
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
    :param resumable: checkpoint the render every `resume_chunk_frames`
        frames, and each overlay decision as it is made (media/resume.py). A
        killed run resumes from the durable frame count, replaying cached
        decisions instead of detecting again, and its output equals an
        unbroken run's. Requires debug_path=None.
    :param debug_path: also write the debug video here (`_debug_tiles`),
        each tile `debug_side_length` square, the overlay and music-mask
        panels windowed by `debug_window` frames, and the synthesis panel
        with the 3D waterfall of the whole stream when `debug_3d`.
    """
    check_resumable(resumable, debug_path)
    overlay_enabled = all(p is not None for p in (phash_distance, bbox_distance, track_length))
    music_mask_enabled = all(
        p is not None
        for p in (complexity_change_rolling_sum_window, complexity_change_threshold)
    )
    if music_mask_enabled and not overlay_enabled:
        raise ValueError("Overlay music mask without overlay being enabled is not supported!")
    device = resolve_device(device)
    placement = _resolve_placement(data_parallel, device_per_network, network_parallel,
                                   network_paths, device)
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
            resumable=resumable,
            resume_chunk_frames=resume_chunk_frames,
            projection_file_path=Path(projection_file_path),
            placement=placement,
            debug_path=debug_path,
            debug_window=debug_window,
            debug_side_length=debug_side_length,
            debug_3d=debug_3d,
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
    resumable: bool = False,
    resume_chunk_frames: int = 300,
    projection_file_path: Optional[Path] = None,
    placement: Tuple = (None, False, False),
    debug_path: Optional[Path] = None,
    debug_window: Optional[int] = None,
    debug_side_length: Optional[int] = None,
    debug_3d: bool = False,
) -> None:
    """
    The render over an open projection file. `reader` needs only
    `projection_attributes` and the lazy `final_latents` and `target_images`
    (each access a fresh iterator), so a caller without h5py can hand in an
    in-memory stand-in. `overlay_gates` is (phash, bbox distance, track
    length), or None for no overlay; a rolling-sum window turns the
    music-complexity mask on. `projection_file_path` enters a resumable
    render's fingerprint beside the file's target md5. `placement` is
    `_resolve_placement`'s (mesh, device_per_network, network_parallel).
    `debug_*` are the API's; the in-memory reader also needs `final_images`
    for the debug video.
    """
    check_resumable(resumable, debug_path)
    mesh, device_per_network, network_parallel = placement
    audio_paths = [Path(p) for p in wav]
    dtype = _compute_dtype(compute_dtype)
    # No output_side_length: synthesized frames leave the device at the
    # network's size and are cubic-scaled on the host, as the targets are.
    with MultiNetwork(
        network_paths=network_paths,
        mesh=mesh,
        device_per_network=device_per_network,
        network_parallel=network_parallel,
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
            music_mask = _music_mask(time_series_audio_vectors, vector_length,
                                     complexity_change_rolling_sum_window, device)
            skip_mask = _skip_mask(music_mask, num_output_frames, complexity_change_threshold)
            if resumable:
                phash_distance, bbox_distance, track_length = overlay_gates or (None,) * 3
                fingerprint = {
                    "pipeline": "projection_file_blend",
                    "wavs": [file_identity(p) for p in audio_paths],
                    "networks": [file_identity(p) for p in network_paths],
                    "projection_file": str(projection_file_path),
                    "projection_file_md5": attributes.target_md5_hash,
                    "alpha": alpha,
                    "fft_roll_enabled": bool(fft_roll_enabled),
                    "fft_amplitude_range": list(fft_amplitude_range),
                    "blend_depth": int(blend_depth),
                    "output_fps": float(output_fps),
                    "output_side_length": int(output_side_length),
                    "frames_to_visualize": frames_to_visualize,
                    "compute_dtype": compute_dtype,
                    "phash_distance": phash_distance,
                    "bbox_distance": bbox_distance,
                    "track_length": track_length,
                    "overlay_detection_side": overlay_detection_side,
                    "overlay_smoothing": overlay_smoothing,
                    "complexity_change_rolling_sum_window": complexity_change_rolling_sum_window,
                    "complexity_change_threshold": complexity_change_threshold,
                }
                total = (num_output_frames if frames_to_visualize is None
                         else min(num_output_frames, frames_to_visualize))
                start = durable_frames(Path(output_path), fingerprint)
                with deterministic_cudnn():  # frames that repeat from run to run
                    frames = _resumable_blend(
                        reader=reader,
                        viz_input=viz_input,
                        multi_networks=multi_networks,
                        output_path=Path(output_path),
                        output_fps=output_fps,
                        output_side_length=output_side_length,
                        frame_multiplier=frame_multiplier,
                        total=total,
                        start=start,
                        audio_paths=audio_paths,
                        skip_mask=skip_mask,
                        overlay_gates=overlay_gates,
                        overlay_detection_side=overlay_detection_side,
                        overlay_smoothing=overlay_smoothing,
                        resume_chunk_frames=resume_chunk_frames,
                        fingerprint=fingerprint,
                        device=device,
                    )
                render.tick(frames - start)
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
                unload_networks_when_complete=True,
            )
            backgrounds = timed_iterator(
                "synth_egress",
                scale_square_source_duplicate(
                    source=synthesis_output.synthesized_images,
                    output_side_length=output_side_length,
                ),
            )
            foregrounds = contexts = None
            if overlay_gates is None:
                blended: Iterator[np.ndarray] = backgrounds
            else:
                blended, foregrounds, contexts = _overlay(
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
                    skip_mask=skip_mask,
                    detection_side=overlay_detection_side,
                    smoothing=overlay_smoothing,
                    device=device,
                    for_debug=debug_path is not None,
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
            if debug_path is not None:
                written = write_debug_video(
                    _debug_tiles(
                        written=written,
                        foregrounds=foregrounds,
                        final_images=reader.final_images,
                        visualization_images=synthesis_output.visualization_images,
                        contexts=contexts,
                        music_mask=music_mask,
                        overlay_gates=overlay_gates,
                        complexity_change_threshold=complexity_change_threshold,
                        frame_multiplier=frame_multiplier,
                        debug_window=debug_window,
                        debug_side_length=debug_side_length,
                    ),
                    debug_path, output_fps, audio_paths,
                )
            render.tick(sum(1 for _ in written))


def _debug_tiles(  # pylint: disable=too-many-arguments
    *,
    written: Iterator[np.ndarray],
    foregrounds: Optional[Iterator[np.ndarray]],
    final_images: Iterator[np.ndarray],
    visualization_images: Iterator[np.ndarray],
    contexts,
    music_mask: Optional[ResultLayers],
    overlay_gates: Optional[Tuple[int, float, int]],
    complexity_change_threshold: Optional[float],
    frame_multiplier: int,
    debug_window: int,
    debug_side_length: int,
) -> List[Optional[Iterator[np.ndarray]]]:
    """The flagship's debug tiles, gance_tpu's six in its order: the blended
    frame as written, the foreground and the overlay panel (with the
    overlay), the file's final image at the output's frame rate, the
    synthesis panel, and the music-mask panel (with the mask). Each frame
    is `debug_side_length` square."""
    from gance_tpu_torch.viz.overlay_viz import (
        VisualizeOverlayThresholds,
        visualize_overlay_computation,
    )
    from gance_tpu_torch.viz.reduction_viz import visualize_result_layers

    def scaled(source, frame_multiplier: int = 1):
        return scale_square_source_duplicate(
            source=source, output_side_length=debug_side_length,
            frame_multiplier=frame_multiplier,
        )

    return [
        scaled(written),
        scaled(foregrounds) if foregrounds is not None else None,
        scaled(final_images, frame_multiplier),
        visualization_images,
        visualize_overlay_computation(
            overlay=contexts,
            frames_per_context=debug_window,
            video_square_side_length=debug_side_length,
            horizontal_lines=VisualizeOverlayThresholds(
                phash_line=overlay_gates[0], bbox_distance_line=overlay_gates[1]
            ),
        ) if overlay_gates is not None else None,
        visualize_result_layers(
            result_layers=music_mask,
            frames_per_context=debug_window,
            video_height=debug_side_length,
            title="Overlay binary mask",
            horizontal_line=complexity_change_threshold,
        ) if music_mask is not None else None,
    ]


def _music_mask(
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    rolling_sum_window: Optional[int],
    device: Device,
) -> Optional[ResultLayers]:
    """The music-complexity mask, or None without a rolling-sum window."""
    if rolling_sum_window is None:
        return None
    return vector_reduction.music_complexity_mask(
        time_series_audio_vectors=time_series_audio_vectors,
        vector_length=vector_length,
        rolling_sum_window=rolling_sum_window,
        device=device,
    )


def _skip_mask(
    music_mask: Optional[ResultLayers], num_output_frames: int, threshold: Optional[float]
) -> List[bool]:
    """Frames on which the overlay is skipped: where the music's complexity
    changes faster than `threshold` (NaN, the rolling sum's warm-up, counts
    as infinitely fast); none without a mask."""
    if music_mask is None:
        return [False] * num_output_frames
    mask_data = np.asarray(music_mask.result.data, dtype=float)
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
    for_debug: bool = False,
) -> Tuple[Iterator[np.ndarray], Optional[Iterator[np.ndarray]], Optional[Iterator]]:
    """The eye-tracked composite. Both streams are disk-teed (NPY): detection
    reads them here, and every decision is materialized (the track-length
    filter needs them all) before the returned stream replays the copies to
    composite. Returns (composited frames, foregrounds, overlay contexts);
    the last two only `for_debug` (the debug video's tiles, drawn in step
    with the composite), else None, and detection keeps no contexts."""
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
        want_contexts=for_debug,
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

    def compose() -> Iterator:
        try:
            for bounding_boxes, foreground, background, in_long_track in zip(
                boxes_list, foreground_copies[1], background_copies[1], long_tracks_mask
            ):
                blended = (
                    write_boxes_onto_image(
                        foreground_image=foreground,
                        background_image=background,
                        bounding_boxes=bounding_boxes,
                    )
                    if in_long_track
                    else background
                )
                yield (blended, foreground) if for_debug else blended
        finally:  # zip stops short of the copies' ends: close them, so the tees clean up
            for stream in foreground_copies + background_copies:
                stream.close()

    if not for_debug:
        return compose(), None, None
    pairs, foreground_pairs = tee(compose())
    return ((pair[0] for pair in pairs), (pair[1] for pair in foreground_pairs),
            overlay_results.contexts)


def _overlay_decisions_path(output_path: Path) -> Path:
    return output_path.with_name(output_path.name + ".overlay.jsonl")


def _load_overlay_decisions(path: Path, fingerprint: dict) -> List[Optional[List[BoundingBox]]]:
    """
    The per-frame overlay decisions a killed resumable run checkpointed
    (detection is the flagship's host bottleneck, far costlier than the
    synthesis that a resume skips). The first line pins the render's
    fingerprint; another fingerprint, a torn header or a torn line before
    the last discards the cache. A torn final line (a kill -9 in the middle
    of its write) is dropped and truncated out of the file.
    """
    if not path.exists():
        return []
    lines = path.read_text().splitlines()
    if not lines:
        return []
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError:
        LOGGER.warning("%s has a torn header; recomputing overlay decisions.", path)
        path.unlink()
        return []
    if header.get("fingerprint") != fingerprint:
        LOGGER.warning(
            "%s was written by a render with different parameters; "
            "recomputing overlay decisions.", path
        )
        path.unlink()
        return []
    decisions: List[Optional[List[BoundingBox]]] = []
    for index, line in enumerate(lines[1:]):
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            if index == len(lines) - 2:
                # Every earlier line ended in a flushed newline, so the prefix
                # is whole. The torn tail has no newline: truncate it, or the
                # next append would weld onto it.
                LOGGER.warning(
                    "%s ends in a torn line (crash mid-write); dropping the "
                    "final record and resuming from %d cached decisions.",
                    path, len(decisions),
                )
                tmp = path.with_name(path.name + ".tmp")
                tmp.write_text("\n".join(lines[:-1]) + "\n", encoding="utf-8")
                os.replace(tmp, path)
                break
            # a torn line in the middle is outside the crash model (a disk
            # error, a second writer): recompute everything
            LOGGER.warning(
                "%s is corrupt at record %d; recomputing overlay decisions.", path, index
            )
            path.unlink()
            return []
        boxes = record["boxes"]
        decisions.append(None if boxes is None else [BoundingBox(*box) for box in boxes])
    return decisions


def _checkpoint_decisions(
    path: Path, fingerprint: dict, start_index: int, decisions: Iterator
) -> Iterator:
    """Append each new decision to the JSON-lines sidecar as it streams through.
    GANCE_TPU_RESUME_DECISION_DELAY (seconds per decision) is a test seam: a
    window in which a kill -9 lands during detection."""
    delay = float(os.environ.get("GANCE_TPU_RESUME_DECISION_DELAY", "0") or 0)
    if start_index == 0 or not path.exists():
        path.write_text(json.dumps({"fingerprint": fingerprint}) + "\n")
    with path.open("a", encoding="utf-8") as handle:
        for boxes in decisions:
            if delay:
                time.sleep(delay)
            handle.write(
                json.dumps({"boxes": None if boxes is None else [list(b) for b in boxes]})
                + "\n"
            )
            handle.flush()
            yield boxes


def _resumable_blend(  # pylint: disable=too-many-arguments,too-many-locals
    *,
    reader,
    viz_input,
    multi_networks,
    output_path: Path,
    output_fps: float,
    output_side_length: int,
    frame_multiplier: int,
    total: int,
    start: int,
    audio_paths: List[Path],
    skip_mask: List[bool],
    overlay_gates: Optional[Tuple[int, float, int]],
    overlay_detection_side: Optional[int],
    overlay_smoothing: int,
    resume_chunk_frames: int,
    fingerprint: dict,
    device: Device,
) -> int:
    """
    The flagship render with checkpoint and resume: `total` frames, of which
    `start` are durable. Hero frames land in finished chunks, and each
    overlay decision in the sidecar as it is made, so a killed run resumes
    synthesis at the durable frame count and detection at the decided one.
    The output equals an unbroken run's: every stage is deterministic, and
    the track-length filter sees the decisions of all frames (the cached
    prefix and the new tail). Returns the finished render's frame count.
    """
    decisions_path = _overlay_decisions_path(output_path)
    cached = (_load_overlay_decisions(decisions_path, fingerprint)[:total]
              if overlay_gates is not None else [])
    done = len(cached)
    if start:
        LOGGER.info(
            "Resuming projection_file_blend at frame %d/%d (%d overlay decisions cached)",
            start, total, done,
        )
    # Temporal smoothing's trailing box history at frame `done` is a function
    # of the last `overlay_smoothing` frames' raw detections, so a replay of
    # detection over the `warm` frames before `done` rebuilds it exactly; the
    # replayed decisions are already in the sidecar and are dropped.
    warm = min(done, overlay_smoothing) if overlay_smoothing > 1 else 0
    detect_from = done - warm
    # Compose needs frames [start, total), detection [detect_from, total).
    # Chunks are written only once every decision is durable, so start > 0
    # implies done == total.
    synth_from = start if (overlay_gates is None or done >= total) else min(start, detect_from)
    backgrounds = timed_iterator(
        "synth_egress",
        scale_square_source_duplicate(
            source=resumed_synthesis(multi_networks, viz_input, synth_from, total,
                                     unload_networks_when_complete=True),
            output_side_length=output_side_length,
        ),
    )

    def scaled_targets() -> Iterator[np.ndarray]:
        # reader.target_images is a fresh lazy iterator on every access
        return timed_iterator(
            "target_read",
            scale_square_source_duplicate(
                source=reader.target_images,
                output_side_length=output_side_length,
                frame_multiplier=frame_multiplier,
            ),
        )

    if overlay_gates is None:
        blended: Iterator[np.ndarray] = backgrounds
    else:
        phash_distance, bbox_distance, track_length = overlay_gates
        streams: List[Iterator[np.ndarray]] = []
        if done < total:
            # both streams feed detection and then compose: disk-tee them
            background_copies = iterator_on_disk(
                iterator=backgrounds, copies=1, serializer=NPY_SERIALIZER)
            target_copies = iterator_on_disk(
                iterator=scaled_targets(), copies=1, serializer=NPY_SERIALIZER)
            streams = [*background_copies, *target_copies]
            overlay_results = compute_eye_tracking_overlay(
                foreground_images=islice(target_copies[0], detect_from, None),
                background_images=islice(background_copies[0], detect_from - synth_from, None),
                min_phash_distance=phash_distance,
                min_bbox_distance=bbox_distance,
                skip_mask=skip_mask[detect_from:],
                detection_side=overlay_detection_side,
                temporal_smoothing=overlay_smoothing,
                want_contexts=False,
                device=device,
            )
            boxes_stream = overlay_results.bbox_lists
            for _ in range(warm):
                next(boxes_stream)  # the warm-up frames' decisions are cached
            # materialized (the track filter needs every decision), each new
            # decision streamed into the sidecar as it is made
            new_boxes = list(timed_iterator("detect", _checkpoint_decisions(
                decisions_path, fingerprint, done, boxes_stream)))
            all_boxes = cached + new_boxes
            background_for_compose = islice(background_copies[1], start - synth_from, None)
            foreground_for_compose = islice(target_copies[1], start, None)
        else:
            all_boxes = cached
            background_for_compose = backgrounds  # starts at `start` already
            foreground_for_compose = islice(scaled_targets(), start, None)
        long_tracks_mask = vector_reduction.track_length_filter(
            bool_tracks=np.asarray(
                [(not skip) and (box is not None) for skip, box in zip(skip_mask, all_boxes)]
            ),
            track_length=track_length,
        )

        def compose() -> Iterator[np.ndarray]:
            try:
                for bounding_boxes, foreground, background, in_long_track in zip(
                    all_boxes[start:], foreground_for_compose, background_for_compose,
                    list(long_tracks_mask)[start:],
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
            finally:  # zip stops short of the copies' ends: close them
                for stream in streams:
                    stream.close()

        blended = compose()

    frames = write_source_resumable(
        source=timed_iterator("compose", blended),
        output_path=output_path,
        video_fps=output_fps,
        fingerprint=fingerprint,
        audio_paths=audio_paths,
        chunk_frames=resume_chunk_frames,
    )
    decisions_path.unlink(missing_ok=True)
    return frames
