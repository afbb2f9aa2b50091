"""
Audio-reactive online synthesis (the counterpart of
gance_tpu/serving/audio.py): the noise-blend transform, music into the latent
space of one or more networks with loudness-driven network switching, and the
flagship projection-file blend, behind the daemon's /synthesize_audio route.

The server plans a request as the offline pipelines do (WAV -> time stretch
locked to the video -> smoothed, scaled spectrogram alpha-blended with seeded
gaussian noise or into a registered projection's first style rows -> RMS-
quantized per-frame network indices), then renders through the
DynamicBatcher: one request per network group, reassembled in frame order.

Planning runs on the host CPU (`device="cpu"` to the port's audio and input
functions), as JAX pins its planning DSP to its CPU backend: planning is host
math in the handler threads, and it queues nothing on the card's stream
beside the dispatch thread's synthesis. The noise source is the seeded
gaussian of `audio/primitives.py`, so the same WAV and parameters give the
same frames on every request.

Departures from gance_tpu, each keeping out a defect the JAX package has:
- `PlanCache.put` makes the cached arrays read-only: every hit shares them,
  so a write downstream would poison later hits.
- `load_projection_registration` refuses a file whose final latents are not
  rows-identical, as `registration_from_latents` refuses posted ones.
- The exact frame cap is checked on a plan-cache hit too, so a request is
  refused or served alike whether its plan was cached or not.
"""

import base64
import binascii
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gance_tpu_torch.utils.logging import LOGGER

DEFAULT_FPS = 30.0
DEFAULT_ALPHA = 0.5
# The offline CLI's spectrogram amplitude range (JAX's cli/music_into_networks.py).
DEFAULT_FFT_AMPLITUDE_RANGE = (-10.0, 10.0)
# Where request planning runs (module docstring).
PLANNING_DEVICE = "cpu"


class PlanCache:
    """
    LRU cache of the request-planning DSP (time stretch, spectrogram, blend,
    reducers). Keyed by everything that decides its output: the WAV bytes'
    hash, fps, alpha and FFT parameters, vector length, palette size, and on
    the flagship path the registered projection's content hash and blend
    depth. The value is the (combined, quantized) pair before the palette
    mapping, so the same clip against another palette of the same size hits.

    Thread-safe. Entries are a few MB each; the byte bound keeps one client
    from ballooning the host. Stored arrays are made read-only, since every
    hit hands out the same objects.
    """

    def __init__(self, max_entries: int = 32, max_bytes: int = 512 << 20) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        self._max_entries = max_entries
        self._max_bytes = max_bytes
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: Tuple, combined: np.ndarray, quantized: np.ndarray) -> None:
        size = combined.nbytes + quantized.nbytes
        if size > self._max_bytes:
            return
        combined.setflags(write=False)
        quantized.setflags(write=False)
        with self._lock:
            if key in self._entries:
                old = self._entries.pop(key)
                self._bytes -= old[0].nbytes + old[1].nbytes
            self._entries[key] = (combined, quantized)
            self._bytes += size
            while self._entries and (
                len(self._entries) > self._max_entries or self._bytes > self._max_bytes
            ):
                _key, (old_combined, old_quantized) = self._entries.popitem(last=False)
                self._bytes -= old_combined.nbytes + old_quantized.nbytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
            }


class AudioSynthesisPlan(NamedTuple):
    """The resolved request: what the device will be asked to render."""

    combined: np.ndarray  # (frames, V) float32 z rows, or (frames, R, V) w+
    indices: np.ndarray  # (frames,) int: the batcher network index of each frame
    selected: List[int]  # the request's network palette (batcher indices)
    fps: float
    vector_length: int
    wav_bytes: bytes  # the original audio, for the "avi" response's mux
    # The flagship's extra state (None / 1 on the noise-blend path):
    projection: Optional[str] = None  # the registered projection's handle
    blend_depth: Optional[int] = None
    frame_multiplier: int = 1


class RegisteredProjection(NamedTuple):
    """A projection file's final latents, resident on the server so that
    requests name them by handle instead of posting megabytes of w+ rows."""

    name: str
    matrices: np.ndarray  # (num_rows, frames * vector_length) float32
    vector_length: int
    num_rows: int
    projection_fps: float
    frame_count: int  # latent count in the file
    label: str
    path: Optional[str] = None  # HDF5 source (None for posted latents)
    # Identifies the latents' content for the plan cache (a handle
    # re-registered with other latents must not hit stale plans).
    content_hash: str = ""


class AudioRequestError(ValueError):
    """Client-side problem with an audio request -> HTTP 400."""


def _require_rows_identical(latents: np.ndarray) -> None:
    """(frames, R, V) final latents must repeat their first style row: the
    blend takes row 0 and re-tiles it, so row-distinct latents would lose rows
    1.. silently."""
    if not np.array_equal(latents, np.broadcast_to(latents[:, :1, :], latents.shape)):
        raise AudioRequestError(
            "final latents must carry identical style rows per frame (the "
            "projector's output property, which the blend's row-0 shortcut "
            f"relies on); row-distinct latents would lose rows 1..{latents.shape[1] - 1} "
            "silently"
        )


def load_projection_registration(path: str, name: Optional[str] = None) -> RegisteredProjection:
    """
    Read and validate a projection file for serving with the offline
    pipeline's gate (complete flag, latent count within 2 of the processed
    frame count) and the rows-identical gate of `registration_from_latents`.
    Host-side HDF5 work only (h5py is imported by the reader).
    """
    from pathlib import Path

    from gance_tpu_torch.projection import file_reader as projection_file_reader

    file_path = Path(path)
    if not file_path.is_file():
        raise AudioRequestError(f"no projection file at {path!r}")
    try:
        with projection_file_reader.load_projection_file(file_path) as reader:
            final_latents = projection_file_reader.final_latents_matrices_label(reader)
            attrs = reader.projection_attributes
            matrices = np.asarray(final_latents.data, np.float32)
            num_rows = matrices.shape[0]
            vector_length = final_latents.vector_length
            frame_count = matrices.shape[1] // vector_length
            if not attrs.complete or abs(frame_count - (attrs.projection_frame_count or 0)) > 2:
                raise AudioRequestError(
                    f"projection file {file_path.name} is incomplete or "
                    "inconsistent; cannot serve it"
                )
            projection_fps = attrs.projection_fps
            if not projection_fps or projection_fps <= 0:
                raise AudioRequestError(
                    f"projection file {file_path.name} records no projection "
                    "fps; cannot lock request fps to it"
                )
            _require_rows_identical(
                matrices.reshape(num_rows, frame_count, vector_length).transpose(1, 0, 2)
            )
            return RegisteredProjection(
                name=name or file_path.stem,
                matrices=matrices,
                vector_length=int(vector_length),
                num_rows=int(num_rows),
                projection_fps=float(projection_fps),
                frame_count=int(frame_count),
                label=final_latents.label,
                path=str(file_path),
                content_hash=_latents_hash(matrices, float(projection_fps)),
            )
    except AudioRequestError:
        raise
    except Exception as error:  # h5py raises assorted types on bad content
        raise AudioRequestError(
            f"could not read projection file {file_path.name}: {error}"
        ) from error


def registration_from_latents(
    final_latents: np.ndarray, projection_fps: float, name: str
) -> RegisteredProjection:
    """Posted final latents (frames, rows, V) -> a registration (no file)."""
    latents = np.asarray(final_latents, np.float32)
    if latents.ndim != 3:
        raise AudioRequestError(
            f"final latents must be (frames, rows, vector_length), got shape {latents.shape}"
        )
    if not projection_fps or projection_fps <= 0:
        raise AudioRequestError('"projection_fps" must be a positive number')
    frames, num_rows, vector_length = latents.shape
    if frames < 1:
        raise AudioRequestError("final latents carry zero frames")
    _require_rows_identical(latents)
    # (frames, R, V) -> the reader's concatenated layout (R, frames * V)
    matrices = np.ascontiguousarray(
        latents.transpose(1, 0, 2).reshape(num_rows, frames * vector_length)
    )
    return RegisteredProjection(
        name=name,
        matrices=matrices,
        vector_length=int(vector_length),
        num_rows=int(num_rows),
        projection_fps=float(projection_fps),
        frame_count=int(frames),
        label=f"posted latents {name}",
        path=None,
        content_hash=_latents_hash(matrices, float(projection_fps)),
    )


def _latents_hash(matrices: np.ndarray, projection_fps: float) -> str:
    digest = hashlib.sha1()
    digest.update(np.ascontiguousarray(matrices).tobytes())
    digest.update(str(projection_fps).encode())
    return digest.hexdigest()


def _float_field(payload: Dict[str, Any], key: str, default: float) -> float:
    """A JSON number field -> float, with bad types as a 400, not a 500."""
    value = payload.get(key, default)
    try:
        return float(value)
    except (TypeError, ValueError) as error:
        raise AudioRequestError(f'"{key}" must be a number, got {value!r}') from error


def _decode_wav(payload: Dict[str, Any]):
    from gance_tpu_torch.audio.io import read_wav_bytes

    encoded = payload.get("wav_base64")
    if not isinstance(encoded, str) or not encoded:
        raise AudioRequestError('"wav_base64" (base64-encoded WAV bytes) is required')
    try:
        raw = base64.b64decode(encoded, validate=True)
    except (binascii.Error, ValueError) as error:
        raise AudioRequestError(f'"wav_base64" is not valid base64: {error}') from error
    try:
        return read_wav_bytes(raw), raw
    except Exception as error:  # scipy raises assorted types on bad content
        raise AudioRequestError(f"could not parse WAV content: {error}") from error


def _check_frame_cap(frames: int, fps: float, frame_cap: int) -> None:
    """The exact noise-blend frame cap, on a plan-cache miss and hit alike."""
    if frames > frame_cap:
        raise AudioRequestError(
            f"{frames} frames at {fps:g} fps exceeds the per-request cap "
            f"of {frame_cap}; send a shorter clip or lower fps"
        )


def plan_audio_request(
    payload: Dict[str, Any],
    networks: Sequence[Any],
    selected: Sequence[int],
    frame_cap: int,
    projection: Optional[RegisteredProjection] = None,
    plan_cache: Optional[PlanCache] = None,
) -> AudioSynthesisPlan:
    """
    Resolve a /synthesize_audio body to the frames the device will render,
    on the host CPU (module docstring).

    `selected` is the request's network palette as batcher indices (the
    daemon resolves names); quantized RMS indices 0..K-1 map onto it in
    order, as the offline CLI's sorted network list does.

    With `projection` this is the flagship transform: the spectrogram is
    alpha-blended into the projection's first `blend_depth` style rows, the
    other rows stay the projection's latents, the request fps must be an
    integer multiple of the projection fps, and the device renders w+
    matrices (no mapping, no truncation).
    """
    wav, wav_raw = _decode_wav(payload)
    if wav.wav_data.size == 0:
        raise AudioRequestError("the WAV contains zero samples")

    fps = _float_field(payload, "fps", DEFAULT_FPS)
    if not 0 < fps <= 240:
        raise AudioRequestError(f'"fps" must be in (0, 240], got {fps}')
    alpha = _float_field(payload, "alpha", DEFAULT_ALPHA)
    if not 0.0 <= alpha <= 1.0:
        raise AudioRequestError(f'"alpha" must be in [0, 1], got {alpha}')
    fft_roll = bool(payload.get("fft_roll", False))
    try:
        amplitude_range = tuple(
            float(edge)
            for edge in payload.get("fft_amplitude_range", DEFAULT_FFT_AMPLITUDE_RANGE)
        )
        if len(amplitude_range) != 2:
            raise AudioRequestError('"fft_amplitude_range" must be a [low, high] pair')
    except (TypeError, ValueError) as error:
        raise AudioRequestError(
            f'"fft_amplitude_range" must be a [low, high] pair: {error}'
        ) from error

    blend_depth: Optional[int] = None
    frame_multiplier = 1
    if projection is None:
        # An estimate of the frame count before the time stretch, so that a
        # long clip is refused before minutes of resampling; the exact count
        # is checked below (on a cache hit too).
        estimated_frames = (wav.wav_data.shape[0] / float(wav.sample_rate)) * fps
        if estimated_frames > frame_cap * 1.05 + 2:
            raise AudioRequestError(
                f"~{int(estimated_frames)} frames at {fps:g} fps exceeds the "
                f"per-request cap of {frame_cap}; send a shorter clip or lower fps"
            )
    else:
        # The offline contract: the output fps is an integer multiple of the
        # projection fps, and the output frame count is multiplier x latent
        # count. The default depth is the CLI's 10, clamped to the rows.
        raw_depth = payload.get("blend_depth", min(10, projection.num_rows))
        if isinstance(raw_depth, bool) or not isinstance(raw_depth, int):
            raise AudioRequestError(f'"blend_depth" must be an integer, got {raw_depth!r}')
        if not 0 <= raw_depth <= projection.num_rows:
            raise AudioRequestError(
                f'"blend_depth" must be in [0, {projection.num_rows}] for '
                f'projection "{projection.name}", got {raw_depth}'
            )
        blend_depth = raw_depth
        if fps != int(fps) or projection.projection_fps != int(projection.projection_fps):
            raise AudioRequestError(
                f"fps {fps:g} and projection fps "
                f"{projection.projection_fps:g} must be whole numbers"
            )
        if int(fps) % int(projection.projection_fps) != 0:
            raise AudioRequestError(
                f"fps {fps:g} must be an integer multiple of projection "
                f'"{projection.name}"\'s fps {projection.projection_fps:g}'
            )
        frame_multiplier = int(fps) // int(projection.projection_fps)
        exact_frames = frame_multiplier * projection.frame_count
        if exact_frames > frame_cap:
            raise AudioRequestError(
                f"{exact_frames} frames ({projection.frame_count} latents x "
                f"{frame_multiplier}) exceeds the per-request cap of "
                f"{frame_cap}; lower fps or register a shorter projection"
            )

    if not selected:
        raise AudioRequestError("no live networks to synthesize with")
    palette_networks = [networks[index] for index in selected]
    if any(network is None for network in palette_networks):
        # a concurrent /admin/unload freed a palette slot after resolution
        raise AudioRequestError("a palette network has been unloaded")
    vector_lengths = {int(network.expected_vector_length) for network in palette_networks}
    if len(vector_lengths) != 1:
        raise AudioRequestError(
            "selected networks disagree on latent length "
            f"({sorted(vector_lengths)}); pick a same-architecture palette"
        )
    resolutions = {int(getattr(network, "resolution", 0)) for network in palette_networks}
    if len(resolutions) != 1:
        raise AudioRequestError(
            f"selected networks disagree on resolution ({sorted(resolutions)}); "
            "frames of one response must share a shape"
        )
    vector_length = next(iter(vector_lengths))
    if projection is not None:
        if projection.vector_length != vector_length:
            raise AudioRequestError(
                f'projection "{projection.name}" carries '
                f"{projection.vector_length}-wide latents but the palette "
                f"networks expect {vector_length}"
            )
        style_rows = {
            int(network.config.num_style_rows)
            for network in palette_networks
            if getattr(network, "config", None) is not None
        }
        if style_rows and style_rows != {projection.num_rows}:
            raise AudioRequestError(
                f'projection "{projection.name}" carries '
                f"{projection.num_rows} style rows but the palette networks "
                f"expect {sorted(style_rows)}"
            )

    # The planning DSP is pure in these inputs. The palette's content is
    # outside the key (only its size shapes the DSP); the mapping runs on hits.
    cache_key = None
    if plan_cache is not None:
        cache_key = (
            hashlib.sha1(wav_raw).hexdigest(), fps, alpha, fft_roll,
            amplitude_range, vector_length, len(selected),
            None if projection is None else projection.content_hash,
            blend_depth,
        )
        cached = plan_cache.get(cache_key)
        if cached is not None:
            combined, quantized = cached
            if projection is None:
                _check_frame_cap(combined.shape[0], fps, frame_cap)
            return _assemble_plan(
                combined, quantized, selected, fps, vector_length, wav_raw,
                projection, blend_depth, frame_multiplier,
            )

    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.synthesis.inputs import (
        alpha_blend_projection_file,
        alpha_blend_vectors_max_rms_power_audio,
    )

    if projection is None:
        scaled = read_wavs_scale_for_video([wav], vector_length=vector_length,
                                           frames_per_second=fps)
        frames = scaled.wav_data.shape[0] // vector_length
        if frames < 1:
            raise AudioRequestError("audio is too short for even one frame")
        # the spectrogram gives one vector per `vector_length` samples of the
        # padded audio, so this is the plan's frame count, checked on hits too
        _check_frame_cap(frames, fps, frame_cap)
    else:
        # lock the stretch to the projection's frame count (offline rule)
        scaled = read_wavs_scale_for_video(
            [wav], vector_length=vector_length,
            target_num_vectors=frame_multiplier * projection.frame_count,
        )

    try:
        if projection is None:
            visualization_input = alpha_blend_vectors_max_rms_power_audio(
                alpha=alpha,
                fft_roll_enabled=fft_roll,
                fft_amplitude_range=amplitude_range,
                time_series_audio_vectors=scaled.wav_data,
                vector_length=vector_length,
                network_indices=list(range(len(selected))),
                device=PLANNING_DEVICE,
            )
        else:
            from gance_tpu_torch.types import MatricesLabel

            visualization_input = alpha_blend_projection_file(
                final_latents_matrices_label=MatricesLabel(
                    data=projection.matrices, vector_length=vector_length,
                    label=projection.label,
                ),
                alpha=alpha,
                fft_roll_enabled=fft_roll,
                fft_amplitude_range=amplitude_range,
                blend_depth=blend_depth,
                time_series_audio_vectors=scaled.wav_data,
                vector_length=vector_length,
                network_indices=list(range(len(selected))),
                device=PLANNING_DEVICE,
            )
    except ValueError as error:
        # the RMS smoothing needs a minimum series length (savgol window 7
        # over the 512-sample-hop RMS frames), as offline
        raise AudioRequestError(
            f"clip too short for the audio feature pipeline: {error}"
        ) from error
    if projection is None:
        combined = np.asarray(visualization_input.combined.data, np.float32).reshape(
            -1, vector_length)
    else:
        # (R, N*V) concatenated matrices -> (N, R, V) w+ rows for the
        # batcher's matrices lane
        matrices = np.asarray(visualization_input.combined.data, np.float32)
        combined = np.ascontiguousarray(
            matrices.reshape(projection.num_rows, -1, vector_length).transpose(1, 0, 2)
        )
    quantized = np.asarray(visualization_input.network_indices.result.data, np.int64)
    if plan_cache is not None and cache_key is not None:
        plan_cache.put(cache_key, combined, quantized)
    return _assemble_plan(
        combined, quantized, selected, fps, vector_length, wav_raw,
        projection, blend_depth, frame_multiplier,
    )


def _assemble_plan(
    combined: np.ndarray,
    quantized: np.ndarray,
    selected: Sequence[int],
    fps: float,
    vector_length: int,
    wav_raw: bytes,
    projection: Optional[RegisteredProjection],
    blend_depth: Optional[int],
    frame_multiplier: int,
) -> AudioSynthesisPlan:
    """The per-request tail after the cacheable DSP: clip to the shorter of
    the frame and index series (the RMS reducer frames audio at a 512 hop, so
    for other vector lengths the two differ slightly; the offline rule), then
    map the quantized indices onto the palette."""
    count = min(combined.shape[0], quantized.shape[0])
    if count < 1:
        raise AudioRequestError("audio is too short for even one frame")
    palette = np.asarray(list(selected), dtype=np.int64)
    indices = palette[np.clip(quantized[:count], 0, len(selected) - 1)]
    return AudioSynthesisPlan(
        combined=combined[:count],
        indices=indices,
        selected=list(selected),
        fps=fps,
        vector_length=vector_length,
        wav_bytes=wav_raw,
        projection=None if projection is None else projection.name,
        blend_depth=blend_depth,
        frame_multiplier=frame_multiplier,
    )


def parse_overlay_params(payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The optional "overlay" object of a /synthesize_audio request: the
    offline CLI's all-or-none overlay options as JSON fields."""
    overlay = payload.get("overlay")
    if overlay is None:
        return None
    if not isinstance(overlay, dict):
        raise AudioRequestError(
            '"overlay" must be an object with "phash_distance", '
            '"bbox_distance", "track_length"'
        )
    required = ("phash_distance", "bbox_distance", "track_length")
    missing = [key for key in required if key not in overlay]
    if missing:
        raise AudioRequestError(
            f'"overlay" is missing {missing} (the overlay gate is '
            "all-or-none, like the offline CLI's option group)"
        )
    try:
        parsed = {
            "phash_distance": int(overlay["phash_distance"]),
            "bbox_distance": float(overlay["bbox_distance"]),
            "track_length": int(overlay["track_length"]),
            "detection_side": (
                int(overlay["detection_side"])
                if overlay.get("detection_side") is not None
                else None
            ),
            "smoothing": int(overlay.get("smoothing", 0)),
        }
    except (TypeError, ValueError) as error:
        raise AudioRequestError(f'bad "overlay" field: {error}') from error
    return parsed


def composite_overlay(
    images: np.ndarray,
    projection: RegisteredProjection,
    frame_multiplier: int,
    overlay_params: Dict[str, Any],
) -> np.ndarray:
    """
    The flagship's eye-tracked overlay on the online render: foreground = the
    projection file's target frames (scaled to the response side, repeated to
    the output fps), background = the synthesized frames; eyes matched and
    gated per frame, short tracks rejected, matched targets composited over
    the synthesis (the offline pipeline's rule, without its streaming). The
    eye crops' pHash runs on the host CPU, like planning.
    """
    from itertools import islice
    from pathlib import Path

    from gance_tpu_torch.audio import reduction as vector_reduction
    from gance_tpu_torch.media.video import scale_square_source_duplicate
    from gance_tpu_torch.overlay.common import write_boxes_onto_image
    from gance_tpu_torch.overlay.eye_tracking import compute_eye_tracking_overlay
    from gance_tpu_torch.projection import file_reader as projection_file_reader

    if projection.path is None:
        raise AudioRequestError(
            f'projection "{projection.name}" was registered from posted '
            "latents; the overlay needs the projection FILE's target frames "
            '— register with {"path": ...}'
        )
    side = int(images.shape[1])
    with projection_file_reader.load_projection_file(Path(projection.path)) as reader:
        targets = list(
            islice(
                scale_square_source_duplicate(
                    source=reader.target_images,
                    output_side_length=side,
                    frame_multiplier=frame_multiplier,
                ),
                len(images),
            )
        )
    if len(targets) < len(images):
        raise AudioRequestError(
            f'projection "{projection.name}" supplies {len(targets)} target '
            f"frames but the request renders {len(images)}"
        )
    overlay_results = compute_eye_tracking_overlay(
        foreground_images=iter(targets),
        background_images=iter(list(images)),
        min_phash_distance=overlay_params["phash_distance"],
        min_bbox_distance=overlay_params["bbox_distance"],
        detection_side=overlay_params.get("detection_side"),
        temporal_smoothing=overlay_params.get("smoothing", 0),
        want_contexts=False,
        device=PLANNING_DEVICE,
    )
    all_boxes = list(overlay_results.bbox_lists)
    long_tracks = vector_reduction.track_length_filter(
        bool_tracks=np.asarray([box is not None for box in all_boxes]),
        track_length=overlay_params["track_length"],
    )
    composited = np.stack(
        [
            write_boxes_onto_image(
                foreground_image=foreground,
                background_image=background,
                bounding_boxes=boxes,
            )
            if in_track
            else background
            for boxes, foreground, background, in_track in zip(
                all_boxes, targets, images, list(long_tracks)
            )
        ]
    )
    LOGGER.info("online overlay: %d/%d frames composited", int(np.sum(long_tracks)), len(images))
    return composited


def encode_music_video(images: np.ndarray, wav_bytes: bytes, fps: float) -> bytes:
    """
    Frames + the original audio -> one playable video file (bytes), through
    the port's writer and mux stack (`media/video.py`: a raw AVI with the
    audio interleaved under GANCE_TPU_EGRESS=raw-spill or on a host with
    neither ffmpeg nor cv2; else ffmpeg, or cv2 and the native muxer). The
    frame count was locked to the clip's duration, so the audio lines up.
    """
    import tempfile
    from pathlib import Path

    from gance_tpu_torch.media.video import write_source_to_disk_consume

    with tempfile.TemporaryDirectory() as tmp:
        wav_path = Path(tmp) / "audio.wav"
        wav_path.write_bytes(wav_bytes)
        video_path = Path(tmp) / "clip.avi"
        write_source_to_disk_consume(
            iter(list(images)), video_path, video_fps=float(fps), audio_paths=[wav_path],
        )
        if list(Path(tmp).glob("clip.audio*.wav")):
            # the mux stack's last resort writes the audio as a sidecar; a
            # silent video would break this route's contract
            raise RuntimeError(
                "no audio muxer available on this host (ffmpeg or the native "
                "AVI muxer) — cannot honor format='avi'"
            )
        return video_path.read_bytes()


def _network_groups(indices: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Frame stream -> one (network_index, frame_positions) group per distinct
    network, in first-appearance order. Loudness near a quantization midpoint
    alternates the index from frame to frame; grouping keeps each network's
    frames in as few full batches as possible, and the caller scatters the
    results back to frame order."""
    seen: List[int] = []
    for index in indices.tolist():
        if index not in seen:
            seen.append(index)
    return [(int(index), np.flatnonzero(indices == index)) for index in seen]


def synthesize_plan(batcher: Any, plan: AudioSynthesisPlan,
                    timeout_s: Optional[float] = None) -> np.ndarray:
    """
    Render the plan through the batcher and return (frames, H, W, 3) uint8 in
    frame order. Every network group is submitted up front, then collected
    against one deadline and scattered back to frame order.
    """
    groups = _network_groups(plan.indices)
    futures = []
    try:
        for network_index, positions in groups:
            futures.append(batcher.submit(plan.combined[positions], network_index=network_index))
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        parts = []
        for future in futures:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            parts.append(future.result(timeout=remaining))
    except BaseException:
        # a failed submit or collect must not strand sibling groups' rows
        for future in futures:
            future.cancel()
        raise
    out = np.empty((len(plan.indices),) + parts[0].shape[1:], dtype=parts[0].dtype)
    for (_index, positions), part in zip(groups, parts):
        out[positions] = part
    LOGGER.info("audio synthesis: %d frames over %d network group(s)",
                len(plan.indices), len(groups))
    return out
