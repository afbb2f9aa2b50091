"""
Online synthesis HTTP daemon over the dynamic batcher.

A small stdlib server (no web-framework dependency on this host class) that
exposes a loaded generator for production serving:

  GET  /healthz      -> {"ok": true, "resolution": R, "vector_length": V, ...}
  GET  /stats        -> batcher counters (batches, occupancy, latency p50/p99,
                        queue wait p50/p95)
  GET  /metrics      -> the same counters in Prometheus text exposition format
                        (scrapeable by any standard monitoring stack)
  POST /synthesize   -> images for a JSON request body:
      {"latents":  [[...], ...]}             z vectors (B, V)
      {"dlatents": [[[...], ...], ...]}      w+ matrices (B, R, V) — skip
                                             mapping/truncation, projection
                                             latents are final
      {"seeds": [0, 1, ...]}                 server-side N(0,1) z per seed
      {"count": N, "seed": S}                N z rows from one RandomState
      optional "format": "npy" (default; one (B, H, W, 3) uint8 np.save blob,
      shape echoed in X-Gance-Shape), "png" (exactly one image), "png-zip"
      (a ZIP of lossless PNGs — compressed egress for full-resolution
      batches), or "avi" (a video of the frames at the request's "fps",
      default 30, through `media/video.py`'s writer);
      optional "network": index or name when the daemon serves several
      resident networks (the reference's MultiNetwork brought online;
      /healthz lists them) — default 0.
  POST /synthesize_audio -> the reference's flagship music->frames transform,
      online (serving/audio.py): {"wav_base64": ..., "fps": 30, "alpha": 0.5,
      "fft_roll": false, "networks": [selectors...]} — the WAV is
      time-stretched to fps, spectrogram/noise-blended into z rows, and each
      frame routes to the network its loudness selects from the palette
      (default: every live network, by index). Returns the npy frame block;
      {"format": "avi"} returns a playable video with the posted audio muxed
      in server-side (the complete reference deliverable from one request);
      {"plan": true} instead returns the routing plan as JSON with no device
      work. With {"projection": <handle>, "blend_depth": N} this is the
      FLAGSHIP projection-file blend (the Won Pound transform) online: the
      spectrogram blends into the first N style rows of the registered final
      latents, the rest stay pure projection, and the device renders w+
      matrices.
  POST /admin/register_projection -> make a projection file's final latents
      resident: {"path": <server-local hdf5>} (validated with the offline
      pipeline's gate) or {"final_latents_base64": <npy b64>,
      "projection_fps": f, "name": ...}. GET /projections lists handles;
      POST /admin/unregister_projection {"name": ...} drops one.
  POST /admin/load {"path": <pkl>} hot-loads a network, POST /admin/unload
      {"network": <index|name>} retires one and frees its device memory.

Concurrency model: ThreadingHTTPServer gives one thread per connection; every
handler submits to the shared DynamicBatcher and blocks on its future, so
concurrent requests coalesce into device batches (batcher.py). The batcher's
one dispatch thread issues all device work. While a profiler records
(`utils/profiling.py`), a /synthesize handler's steps are spans
(`serving.http.parse`, `.await_result`, `.encode`, `.write`) that share the
request's id with the batcher's spans of it.

The counterpart of gance_tpu/serving/daemon.py: the same routes, bodies,
statuses and wire format. Departures: registered projections are held to a
byte bound (`MAX_PROJECTION_BYTES`, 1 GiB; a registration past it
is refused with 400, where the JAX package has no bound), and `drain()` also
waits for the responses being written.
"""

import io
import json
import os
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from gance_tpu_torch.serving.batcher import DynamicBatcher, next_request_id
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import span

MAX_BODY_BYTES = 256 * 1024 * 1024  # latents are small; refuse absurd bodies
MAX_FRAMES_PER_REQUEST = 4096
# Response-size cap: the frame cap alone ignores resolution (4096 frames of a
# 1024px generator is ~13 GB before the npy/concat copies). Bounded by bytes
# so one request can never OOM the host.
MAX_RESPONSE_BYTES = int(
    os.environ.get("GANCE_TPU_SERVE_MAX_RESPONSE_BYTES", str(1 << 30))
)
# How long a handler waits on its future before returning 503: bounds every
# client wait even if the device stops answering.
REQUEST_TIMEOUT_S = float(os.environ.get("GANCE_TPU_SERVE_TIMEOUT_S", "600"))
# Bound on the bytes of all registered projections' latents together, in the
# style of the plan cache's byte bound.
MAX_PROJECTION_BYTES = 1 << 30


class ServingError(ValueError):
    """Client-side request problem -> HTTP 400."""


def max_frames_for(resolution: int) -> int:
    """Per-request frame cap honoring both the frame and response-byte caps."""
    if resolution <= 0:  # unknown resolution: frame cap only
        return MAX_FRAMES_PER_REQUEST
    frame_bytes = resolution * resolution * 3
    return max(1, min(MAX_FRAMES_PER_REQUEST, MAX_RESPONSE_BYTES // frame_bytes))


def _rows_from_request(
    payload: Dict[str, Any],
    vector_length: int,
    frame_cap: int,
    style_rows: Optional[int] = None,
) -> np.ndarray:
    """Resolve the request body to a float32 batch (validated shapes)."""
    if not isinstance(payload, dict):
        raise ServingError(
            f"request body must be a JSON object, got {type(payload).__name__}"
        )
    sources = [k for k in ("latents", "dlatents", "seeds", "count") if k in payload]
    if len(sources) != 1:
        raise ServingError(
            "provide exactly one of 'latents', 'dlatents', 'seeds', 'count' "
            f"(got {sources or 'none'})"
        )
    key = sources[0]
    if key == "latents":
        rows = np.asarray(payload["latents"], np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != vector_length:
            raise ServingError(
                f"'latents' must be (B, {vector_length}), got {rows.shape}"
            )
    elif key == "dlatents":
        rows = np.asarray(payload["dlatents"], np.float32)
        if rows.ndim == 2:
            rows = rows[None, ...]
        if rows.ndim != 3 or rows.shape[2] != vector_length:
            raise ServingError(
                f"'dlatents' must be (B, rows, {vector_length}), got {rows.shape}"
            )
        if style_rows is not None and rows.shape[1] != style_rows:
            raise ServingError(
                f"'dlatents' must carry {style_rows} style rows for this "
                f"network, got {rows.shape[1]}"
            )
    elif key == "seeds":
        seeds = payload["seeds"]
        if not isinstance(seeds, list) or not seeds:
            raise ServingError("'seeds' must be a non-empty list of integers")
        rows = np.stack(
            [
                np.random.RandomState(int(seed)).randn(vector_length)
                for seed in seeds
            ]
        ).astype(np.float32)
    else:  # count
        count = int(payload["count"])
        if count < 1:
            raise ServingError("'count' must be >= 1")
        rng = np.random.RandomState(int(payload.get("seed", 0)))
        rows = rng.randn(count, vector_length).astype(np.float32)
    if rows.shape[0] > frame_cap:
        raise ServingError(
            f"request of {rows.shape[0]} frames exceeds the per-request cap "
            f"of {frame_cap} (bounded by frame count and response bytes)"
        )
    return rows


_FORMATS = ("npy", "png", "png-zip", "avi")


def _validate_format(fmt: str, num_frames: int) -> None:
    """Reject bad `format` BEFORE device work is spent on the request."""
    if fmt not in _FORMATS:
        raise ServingError(
            f"unknown format {fmt!r} (expected one of {', '.join(_FORMATS)})"
        )
    if fmt == "png" and num_frames != 1:
        raise ServingError("'format': 'png' requires exactly one image")


_ENCODER_POOL = None
_ENCODER_POOL_LOCK = threading.Lock()


def _encoder_pool():
    """Shared PNG-encode thread pool (lazy): per-request pools would pay
    thread churn and let K concurrent requests run K x N_cpu threads."""
    global _ENCODER_POOL  # noqa: PLW0603 - process-lifetime singleton
    with _ENCODER_POOL_LOCK:
        if _ENCODER_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _ENCODER_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="png-encode",
            )
        return _ENCODER_POOL


def _encode_png(image: np.ndarray) -> bytes:
    import cv2

    ok, encoded = cv2.imencode(".png", cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
    if not ok:
        raise RuntimeError("PNG encode failed")
    return encoded.tobytes()


def _encode_images(
    images: np.ndarray, fmt: str, fps: float = 30.0
) -> Tuple[bytes, str]:
    """(B, H, W, 3) uint8 -> (body, content_type).

    Compressed egress formats (npy is 3 MB a frame at 1024px):
      * "png-zip": a ZIP (stored: PNG is already deflated) of one lossless
        PNG per frame (cv2), encoded on a thread pool.
      * "avi": the frames as a video through the offline CLIs' writer stack
        (`media/video.py`: a raw AVI under GANCE_TPU_EGRESS=raw-spill, else
        ffmpeg or cv2's mp4v). The request's "fps" (default 30) sets the
        timebase.
    """
    if fmt == "npy":
        buffer = io.BytesIO()
        np.save(buffer, images)
        return buffer.getvalue(), "application/octet-stream"
    if fmt == "png":
        if images.shape[0] != 1:  # unreachable: _validate_format ran pre-submit
            raise ServingError("'format': 'png' requires exactly one image")
        return _encode_png(images[0]), "image/png"
    if fmt == "png-zip":
        import zipfile

        if len(images) > 1 and (os.cpu_count() or 1) > 1:
            blobs = list(_encoder_pool().map(_encode_png, list(images)))
        else:
            blobs = [_encode_png(image) for image in images]
        buffer = io.BytesIO()
        with zipfile.ZipFile(buffer, "w", zipfile.ZIP_STORED) as archive:
            for index, blob in enumerate(blobs):
                archive.writestr(f"frame_{index:06d}.png", blob)
        return buffer.getvalue(), "application/zip"
    if fmt == "avi":
        import tempfile
        from pathlib import Path

        from gance_tpu_torch.media.video import write_source_to_disk_consume

        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "frames.avi"
            write_source_to_disk_consume(
                iter(list(images)), path, video_fps=float(fps)
            )
            return path.read_bytes(), "video/x-msvideo"
    raise ServingError(
        f"unknown format {fmt!r} (expected one of {', '.join(_FORMATS)})"
    )


def _prometheus_metrics(daemon: "SynthesisDaemon") -> str:
    """Batcher counters in Prometheus text exposition format (v0.0.4)."""
    stats = daemon.batcher.stats()
    lines = []

    def metric(name: str, kind: str, help_text: str, value, labels: str = "") -> None:
        lines.append(f"# HELP gance_serving_{name} {help_text}")
        lines.append(f"# TYPE gance_serving_{name} {kind}")
        lines.append(f"gance_serving_{name}{labels} {value}")

    metric("requests_total", "counter", "Requests accepted by the batcher",
           stats["requests"])
    metric("frames_total", "counter", "Real frames synthesized", stats["frames"])
    metric("batches_total", "counter", "Device batches dispatched",
           stats["batches"])
    metric("dispatched_rows_total", "counter",
           "Device rows dispatched including bucket padding",
           stats["dispatched_rows"])
    metric("errors_total", "counter", "Dispatch/fetch failures", stats["errors"])
    metric("live_requests", "gauge", "Requests not yet resolved",
           daemon.batcher.live_requests())
    metric("draining", "gauge", "1 while refusing new requests for shutdown",
           int(daemon.draining))
    if stats.get("occupancy") is not None:
        metric("occupancy", "gauge",
               "Real frames / dispatched rows (bucket fill)",
               round(stats["occupancy"], 6))
    for quantile in ("p50", "p99"):
        key = f"latency_{quantile}_ms"
        if key in stats:
            metric(f"latency_{quantile}_seconds", "gauge",
                   f"Request latency {quantile} over the last 512 requests",
                   round(stats[key] / 1e3, 6))
    for quantile in ("p50", "p95"):
        key = f"queue_wait_{quantile}_ms"
        if key in stats:
            metric(f"queue_wait_{quantile}_seconds", "gauge",
                   f"Queue wait (submit to the dispatch of a request's last rows) "
                   f"{quantile} over the last 512 requests",
                   round(stats[key] / 1e3, 6))
    cache_stats = daemon.plan_cache.stats()
    metric("plan_cache_hits_total", "counter",
           "Audio planning-DSP cache hits", cache_stats["hits"])
    metric("plan_cache_misses_total", "counter",
           "Audio planning-DSP cache misses", cache_stats["misses"])
    metric("plan_cache_entries", "gauge",
           "Resident audio plans", cache_stats["entries"])
    frames_by_network = stats.get("frames_by_network")
    if frames_by_network:
        lines.append(
            "# HELP gance_serving_network_frames_total Frames per resident network"
        )
        lines.append("# TYPE gance_serving_network_frames_total counter")
        # zip, not an index loop: during a hot load the batcher's counter list
        # is extended before daemon.network_names, so a concurrent scrape can
        # see one more counter than names — the unnamed tail is dropped
        # rather than crashing the scrape.
        for name, count in zip(list(daemon.network_names), frames_by_network):
            lines.append(
                f'gance_serving_network_frames_total{{network="{_escape_label(name)}"}} '
                f"{count}"
            )
    return "\n".join(lines) + "\n"


def _escape_label(value: str) -> str:
    """Prometheus exposition-format label escaping (a pickle stem with a
    quote or backslash must not invalidate the whole scrape)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class SynthesisDaemon:
    """
    Own a network + batcher + HTTP server. `network` is any SynthesisNetwork-
    shaped object (including FakeSynthesisNetwork in tests), or a list of
    them. Port 0 binds an ephemeral port (read `.port` after construction).
    """

    def __init__(
        self,
        network: Any,
        host: str = "127.0.0.1",
        port: int = 8799,
        max_batch: int = 48,
        max_delay_ms: float = 5.0,
        network_loader: Optional[Any] = None,
        network_unloader: Optional[Any] = None,
    ) -> None:
        # Rollout without downtime: with `network_loader(path, index)` (or a
        # two-phase loader with `prepare` and `commit`), POST /admin/load
        # hot-adds a resident network, its device placement run under the
        # batcher's device lock; POST /admin/unload retires one by name or
        # index: the edge stops routing at once, in-flight requests finish,
        # then the slot and its device memory are dropped.
        # `network_unloader(index)` (optional) is called after the drop.
        self.network_loader = network_loader
        self.network_unloader = network_unloader
        self._admin_lock = threading.Lock()
        self._retired: set = set()
        # Registered projections: the final latents stay on the server so
        # that /synthesize_audio requests carry only audio; their bytes
        # together stay within `MAX_PROJECTION_BYTES`.
        self.projections: Dict[str, Any] = {}
        self._projections_lock = threading.Lock()
        # Repeated audio requests (same clip and parameters) skip planning.
        from gance_tpu_torch.serving.audio import PlanCache

        self.plan_cache = PlanCache()
        # Requests pick a resident network with {"network": <index|name>},
        # default 0. One batcher serves them all: its lanes keep each device
        # batch single-network.
        self.networks: list = (
            list(network) if isinstance(network, (list, tuple)) else [network]
        )
        self.network = self.networks[0]
        self.frame_caps = [
            max_frames_for(int(getattr(n, "resolution", 0))) for n in self.networks
        ]
        self.frame_cap = self.frame_caps[0]
        # Real networks accept exactly config.num_style_rows w+ rows; fakes
        # (no config) accept any row count.
        self.style_rows_by_network: list = [
            int(n.config.num_style_rows) if getattr(n, "config", None) is not None
            else None
            for n in self.networks
        ]
        self.style_rows = self.style_rows_by_network[0]
        # Name -> index: the pickle's file stem (unique stems only — ambiguous
        # names stay index-addressable; digit strings resolve as indices in
        # resolve_network_index, names winning on a collision).
        self.network_names: list = [
            (Path(str(n.path)).stem if getattr(n, "path", None) else f"network_{i}")
            for i, n in enumerate(self.networks)
        ]
        self._rebuild_name_map()
        self.batcher = DynamicBatcher(
            self.networks, max_batch=max_batch, max_delay_ms=max_delay_ms
        )
        self._draining = threading.Event()
        # POST handlers that have not written their response yet
        self._responding = 0
        self._responding_lock = threading.Lock()
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            # stdlib logs every request to stderr by default; route to LOGGER
            def log_message(self, fmt: str, *args: Any) -> None:
                LOGGER.debug("serving: " + fmt, *args)

            def _reply(
                self, status: int, body: bytes, content_type: str,
                extra: Optional[Dict[str, str]] = None,
            ) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for key, value in (extra or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, status: int, payload: Dict[str, Any]) -> None:
                self._reply(
                    status, json.dumps(payload).encode(), "application/json"
                )

            def do_GET(self) -> None:  # noqa: N802 (stdlib API)
                if self.path == "/healthz":
                    self._reply_json(200, daemon.health())
                elif self.path == "/projections":
                    self._reply_json(200, daemon.list_projections())
                elif self.path == "/stats":
                    stats = daemon.batcher.stats()
                    stats["plan_cache"] = daemon.plan_cache.stats()
                    self._reply_json(200, stats)
                elif self.path == "/metrics":
                    self._reply(
                        200, _prometheus_metrics(daemon).encode(),
                        "text/plain; version=0.0.4",
                    )
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def _read_json_body(self) -> Dict[str, Any]:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0 or length > MAX_BODY_BYTES:
                    raise ServingError("missing or oversized request body")
                payload = json.loads(self.rfile.read(length))
                if not isinstance(payload, dict):
                    raise ServingError("request body must be a JSON object")
                return payload

            def _do_admin(self) -> None:
                try:
                    payload = self._read_json_body()
                    if self.path == "/admin/load":
                        if daemon.network_loader is None:
                            self._reply_json(
                                501,
                                {"error": "this daemon has no network loader "
                                 "(start it with python -m gance_tpu_torch.cli.serve)"},
                            )
                            return
                        self._reply_json(
                            200, daemon.load_network(payload.get("path"))
                        )
                    else:
                        self._reply_json(
                            200,
                            daemon.unload_network(payload.get("network")),
                        )
                except (ServingError, ValueError, json.JSONDecodeError) as error:
                    self._reply_json(400, {"error": str(error)})
                except Exception as error:  # pylint: disable=broad-except
                    LOGGER.exception("admin request failed")
                    self._reply_json(500, {"error": str(error)})

            def _do_projection_admin(self) -> None:
                from gance_tpu_torch.serving.audio import AudioRequestError

                try:
                    payload = self._read_json_body()
                    if self.path == "/admin/register_projection":
                        self._reply_json(
                            200, daemon.register_projection(payload)
                        )
                    else:
                        self._reply_json(
                            200, daemon.unregister_projection(payload)
                        )
                except (
                    AudioRequestError, ServingError, ValueError,
                    json.JSONDecodeError,
                ) as error:
                    self._reply_json(400, {"error": str(error)})
                except Exception as error:  # pylint: disable=broad-except
                    LOGGER.exception("projection admin request failed")
                    self._reply_json(500, {"error": str(error)})

            def _do_synthesize_audio(self) -> None:
                from concurrent.futures import TimeoutError as _FuturesTimeout

                from gance_tpu_torch.serving.audio import (
                    AudioRequestError,
                    composite_overlay,
                    encode_music_video,
                    parse_overlay_params,
                    plan_audio_request,
                    synthesize_plan,
                )

                try:
                    payload = self._read_json_body()
                    fmt = payload.get("format", "npy")
                    if fmt not in ("npy", "avi"):
                        raise ServingError(
                            f"unknown audio format {fmt!r} (expected 'npy' "
                            "frames or 'avi' — a playable video with the "
                            "posted audio muxed in)"
                        )
                    overlay_params = parse_overlay_params(payload)
                    if overlay_params is not None and fmt != "avi":
                        raise ServingError(
                            '"overlay" composites the projection targets '
                            "into the music video — it requires "
                            '{"format": "avi"}'
                        )
                    if overlay_params is not None and not payload.get(
                        "projection"
                    ):
                        raise ServingError(
                            '"overlay" needs a registered projection (its '
                            "target frames are the overlay foreground)"
                        )
                    selected = daemon.resolve_audio_palette(payload)
                    frame_cap = min(daemon.frame_caps[i] for i in selected)
                    projection = daemon.resolve_projection(payload)
                    if (
                        overlay_params is not None
                        and projection is not None
                        and projection.path is None
                    ):
                        # pre-flight: composite_overlay would reject this
                        # anyway, but only AFTER the full device render
                        raise ServingError(
                            f'projection "{projection.name}" was registered '
                            "from posted latents; the overlay needs the "
                            "projection FILE's target frames — register "
                            'with {"path": ...}'
                        )
                    plan = plan_audio_request(
                        payload, daemon.networks, selected, frame_cap,
                        projection=projection, plan_cache=daemon.plan_cache,
                    )
                    if payload.get("plan"):
                        # routing-plan preview: no device work
                        preview = {
                            "frames": int(plan.indices.shape[0]),
                            "fps": plan.fps,
                            "vector_length": plan.vector_length,
                            "indices": [int(i) for i in plan.indices],
                            "names": [
                                daemon.network_names[i] for i in plan.selected
                            ],
                        }
                        if plan.projection is not None:
                            preview["projection"] = plan.projection
                            preview["blend_depth"] = plan.blend_depth
                            preview["frame_multiplier"] = plan.frame_multiplier
                        self._reply_json(200, preview)
                        return
                    try:
                        images = synthesize_plan(
                            daemon.batcher, plan, timeout_s=REQUEST_TIMEOUT_S
                        )
                    except _FuturesTimeout:
                        self._reply_json(
                            503,
                            {"error": f"synthesis timed out after "
                             f"{REQUEST_TIMEOUT_S:g}s"},
                        )
                        return
                    if fmt == "avi":
                        if overlay_params is not None:
                            # the eye-tracked overlay: the registered
                            # projection file's target frames composited
                            # over the synthesis where the gates agree
                            images = composite_overlay(
                                images, projection, plan.frame_multiplier,
                                overlay_params,
                            )
                        # frames at fps with the posted audio, muxed here
                        body = encode_music_video(images, plan.wav_bytes, plan.fps)
                        content_type = "video/x-msvideo"
                    else:
                        body, content_type = _encode_images(images, "npy")
                except (
                    AudioRequestError, ServingError, ValueError,
                    json.JSONDecodeError,
                ) as error:
                    self._reply_json(400, {"error": str(error)})
                    return
                except Exception as error:  # pylint: disable=broad-except
                    LOGGER.exception("audio serving request failed")
                    self._reply_json(500, {"error": str(error)})
                    return
                self._reply(
                    200, body, content_type,
                    extra={"X-Gance-Shape": "x".join(map(str, images.shape))},
                )

            def do_POST(self) -> None:  # noqa: N802
                # Counted until the response is written, so drain waits for
                # it; a request that arrives once draining has begun is not
                # counted, so retries turned away with 503 cannot hold drain.
                with daemon._responding_lock:
                    admitted = not daemon.draining
                    if admitted:
                        daemon._responding += 1
                try:
                    self._post()
                finally:
                    if admitted:
                        with daemon._responding_lock:
                            daemon._responding -= 1

            def _post(self) -> None:
                if self.path in (
                    "/admin/register_projection",
                    "/admin/unregister_projection",
                ):
                    if daemon.draining:
                        self._reply_json(503, {"error": "daemon is draining"})
                        return
                    self._do_projection_admin()
                    return
                if self.path in ("/admin/load", "/admin/unload"):
                    if daemon.draining:
                        self._reply_json(503, {"error": "daemon is draining"})
                        return
                    self._do_admin()
                    return
                if self.path not in ("/synthesize", "/synthesize_audio"):
                    self._reply_json(404, {"error": f"no route {self.path}"})
                    return
                if daemon.draining:
                    # Graceful shutdown: in-flight work finishes, new work is
                    # turned away with a retryable status.
                    self._reply_json(503, {"error": "daemon is draining"})
                    return
                if self.path == "/synthesize_audio":
                    self._do_synthesize_audio()
                    return
                request_id = next_request_id()
                try:
                    with span("serving.http.parse", request=request_id):
                        payload = self._read_json_body()
                        index = daemon.resolve_network_index(payload)
                        # Snapshot the object: a concurrent /admin/unload may
                        # None the slot between resolve and here (submit's
                        # own locked check is the authoritative gate).
                        network = daemon.networks[index]
                        if network is None:
                            raise ServingError(f"network {index} has been unloaded")
                        rows = _rows_from_request(
                            payload,
                            network.expected_vector_length,
                            daemon.frame_caps[index],
                            style_rows=daemon.style_rows_by_network[index],
                        )
                        fmt = payload.get("format", "npy")
                        _validate_format(fmt, rows.shape[0])
                        # parse + range-check avi's fps BEFORE device work,
                        # like every other request-shape gate
                        try:
                            fps = float(payload.get("fps", 30.0))
                        except (TypeError, ValueError) as error:
                            raise ServingError(
                                f'"fps" must be a number: {error}'
                            ) from error
                        if fmt == "avi" and not 0 < fps <= 240:
                            raise ServingError(
                                f'"fps" must be in (0, 240], got {fps:g}'
                            )
                    future = daemon.batcher.submit(
                        rows, network_index=index, request_id=request_id
                    )
                    try:
                        with span("serving.http.await_result", request=request_id):
                            images = future.result(timeout=REQUEST_TIMEOUT_S)
                    except FuturesTimeout:
                        future.cancel()  # drops any undispatched rows
                        self._reply_json(
                            503,
                            {"error": f"synthesis timed out after "
                             f"{REQUEST_TIMEOUT_S:g}s"},
                        )
                        return
                    with span("serving.http.encode", request=request_id):
                        body, content_type = _encode_images(images, fmt, fps=fps)
                except (ServingError, ValueError, json.JSONDecodeError) as error:
                    self._reply_json(400, {"error": str(error)})
                    return
                except Exception as error:  # pylint: disable=broad-except
                    LOGGER.exception("serving request failed")
                    self._reply_json(500, {"error": str(error)})
                    return
                with span("serving.http.write", request=request_id):
                    self._reply(
                        200, body, content_type,
                        extra={"X-Gance-Shape": "x".join(map(str, images.shape))},
                    )

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serving-http", daemon=True
        )

    def _rebuild_name_map(self) -> None:
        """Name -> index over LIVE slots only (unique names; retiring a
        network frees its name, which is how same-stem rollouts work:
        unload old, load new)."""
        live_names = [
            name
            for index, name in enumerate(self.network_names)
            if index not in self._retired
        ]
        self._name_to_index = {
            name: index
            for index, name in enumerate(self.network_names)
            if index not in self._retired and live_names.count(name) == 1
        }

    def live_network_names(self) -> list:
        return [
            name
            for index, name in enumerate(self.network_names)
            if index not in self._retired
        ]

    def resolve_network_index(self, payload: Any) -> int:
        """The network a request addresses: the optional "network" field is an
        index or a served name; absent means network 0."""
        selector = payload.get("network", 0) if isinstance(payload, dict) else 0
        if isinstance(selector, bool):
            raise ServingError('"network" must be an index or name')
        if isinstance(selector, str):
            if selector in self._name_to_index:
                selector = self._name_to_index[selector]
            # a stringified index ("1" from a form field / env var) works
            # too; served names win when one collides
            elif selector.isdigit() and int(selector) < len(self.networks):
                selector = int(selector)
            else:
                raise ServingError(
                    f'unknown network "{selector}" (serving: '
                    f'{", ".join(self.live_network_names())})'
                )
        if not isinstance(selector, int):
            raise ServingError('"network" must be an index or name')
        if not 0 <= selector < len(self.networks):
            raise ServingError(
                f'"network" index {selector} out of range '
                f"(serving {len(self.networks)} networks)"
            )
        if selector in self._retired or self.networks[selector] is None:
            raise ServingError(
                f'network {selector} ("{self.network_names[selector]}") has '
                "been unloaded"
            )
        return selector

    def resolve_audio_palette(self, payload: Any) -> list:
        """The ordered network palette an audio request's quantized indices
        map onto: the optional "networks" list (indices/names, resolved like
        "network"), or every LIVE network by index — the same semantics as
        the offline CLI's sorted network list."""
        selectors = payload.get("networks") if isinstance(payload, dict) else None
        if selectors is None:
            palette = [
                index
                for index, network in enumerate(self.networks)
                if index not in self._retired and network is not None
            ]
            if not palette:
                raise ServingError("no live networks")
            return palette
        if not isinstance(selectors, list) or not selectors:
            raise ServingError(
                '"networks" must be a non-empty list of indices or names'
            )
        palette = [
            self.resolve_network_index({"network": selector})
            for selector in selectors
        ]
        if len(set(palette)) != len(palette):
            raise ServingError('"networks" palette repeats a network')
        return palette

    def register_projection(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """
        POST /admin/register_projection: make a projection file's final
        latents resident so /synthesize_audio requests can blend against them
        by handle. Two sources: {"path": <server-local hdf5>} reads + validates
        a projection file with the offline pipeline's gate, or
        {"final_latents_base64": <b64 npy (frames, rows, V)>,
        "projection_fps": f} registers posted latents directly. Optional
        "name" overrides the handle (default: file stem / required for posted
        latents). Host-side only: no device memory until a request renders.
        A registration that would take the registered latents past
        `MAX_PROJECTION_BYTES` is refused (400).
        """
        import base64
        import binascii
        import io as _io

        from gance_tpu_torch.serving.audio import (
            load_projection_registration,
            registration_from_latents,
        )

        name = payload.get("name")
        if name is not None and (not isinstance(name, str) or not name):
            raise ServingError('"name" must be a non-empty string')
        path = payload.get("path")
        encoded = payload.get("final_latents_base64")
        if (path is None) == (encoded is None):
            raise ServingError(
                'provide exactly one of "path" (server-local projection '
                'file) or "final_latents_base64" (+ "projection_fps")'
            )
        if path is not None:
            if not isinstance(path, str):
                raise ServingError('"path" must be a string')
            registration = load_projection_registration(path, name=name)
        else:
            if name is None:
                raise ServingError('posted latents need an explicit "name"')
            if not isinstance(encoded, str):
                raise ServingError(
                    '"final_latents_base64" must be a base64 string'
                )
            try:
                raw = base64.b64decode(encoded, validate=True)
                latents = np.load(_io.BytesIO(raw), allow_pickle=False)
            except (binascii.Error, ValueError) as error:
                raise ServingError(
                    f'"final_latents_base64" must be base64 npy: {error}'
                ) from error
            try:
                fps = float(payload.get("projection_fps", 0))
            except (TypeError, ValueError) as error:
                raise ServingError(
                    '"projection_fps" must be a number'
                ) from error
            registration = registration_from_latents(latents, fps, name)
        with self._projections_lock:
            replaced = registration.name in self.projections
            resident = sum(
                r.matrices.nbytes for n, r in self.projections.items()
                if n != registration.name
            )
            if resident + registration.matrices.nbytes > MAX_PROJECTION_BYTES:
                raise ServingError(
                    f'projection "{registration.name}" ({registration.matrices.nbytes} '
                    f"bytes) would take the registered latents to "
                    f"{resident + registration.matrices.nbytes} bytes, past the "
                    f"bound of {MAX_PROJECTION_BYTES}; unregister one first"
                )
            self.projections[registration.name] = registration
        LOGGER.info(
            "registered projection %r: %d frames x %d rows @ %g fps%s",
            registration.name, registration.frame_count,
            registration.num_rows, registration.projection_fps,
            " (replaced)" if replaced else "",
        )
        return {
            "name": registration.name,
            "frames": registration.frame_count,
            "rows": registration.num_rows,
            "vector_length": registration.vector_length,
            "projection_fps": registration.projection_fps,
            "replaced": replaced,
        }

    def unregister_projection(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        name = payload.get("name")
        if not isinstance(name, str) or not name:
            raise ServingError('"name" must be a non-empty string')
        with self._projections_lock:
            if name not in self.projections:
                raise ServingError(
                    f'no registered projection "{name}" '
                    f"(registered: {sorted(self.projections)})"
                )
            del self.projections[name]
        LOGGER.info("unregistered projection %r", name)
        return {"name": name, "unregistered": True}

    def list_projections(self) -> Dict[str, Any]:
        with self._projections_lock:
            registrations = list(self.projections.values())
        return {
            "projections": [
                {
                    "name": r.name,
                    "frames": r.frame_count,
                    "rows": r.num_rows,
                    "vector_length": r.vector_length,
                    "projection_fps": r.projection_fps,
                    "path": r.path,
                }
                for r in registrations
            ]
        }

    def resolve_projection(self, payload: Any) -> Optional[Any]:
        """The registration a /synthesize_audio request's optional
        "projection" handle names (None = noise-blend path)."""
        name = payload.get("projection") if isinstance(payload, dict) else None
        if name is None:
            return None
        if not isinstance(name, str) or not name:
            raise ServingError('"projection" must be a registered handle name')
        with self._projections_lock:
            registration = self.projections.get(name)
        if registration is None:
            raise ServingError(
                f'no registered projection "{name}" '
                f"(registered: {sorted(self.projections)}); POST "
                "/admin/register_projection first"
            )
        return registration

    def load_network(self, path: Any) -> Dict[str, Any]:
        """Hot-add a resident network from a pickle path (POST /admin/load).
        The loader's device work runs under the batcher's device lock, so it
        never interleaves with a dispatch."""
        if not path or not isinstance(path, str):
            raise ServingError('"path" must be a pickle path string')
        if self.network_loader is None:
            raise ServingError("this daemon has no network loader")
        with self._admin_lock:
            index = len(self.networks)
            prepare = getattr(self.network_loader, "prepare", None)
            commit = getattr(self.network_loader, "commit", None)
            if prepare is not None and commit is not None:
                # Two-phase loader: the host-side pickle parse (the slow
                # part) runs outside the device lock, so serving goes on
                # through it; only the device placement pauses dispatches.
                staged = prepare(path, index)
                network = self.batcher.run_exclusive(
                    lambda: commit(staged, path, index)
                )
            else:
                network = self.batcher.run_exclusive(
                    lambda: self.network_loader(path, index)
                )
            batcher_index = self.batcher.add_network(network)
            if batcher_index != index:  # only possible via API misuse
                raise RuntimeError(
                    f"slot skew: daemon {index} != batcher {batcher_index}"
                )
            self.networks.append(network)
            self.frame_caps.append(
                max_frames_for(int(getattr(network, "resolution", 0)))
            )
            self.style_rows_by_network.append(
                int(network.config.num_style_rows)
                if getattr(network, "config", None) is not None
                else None
            )
            self.network_names.append(
                Path(str(network.path)).stem
                if getattr(network, "path", None)
                else f"network_{index}"
            )
            self._rebuild_name_map()
        LOGGER.info(
            "hot-loaded network %d (%s) from %s",
            index, self.network_names[index], path,
        )
        return {
            "index": index,
            "name": self.network_names[index],
            "resolution": int(getattr(network, "resolution", 0)),
            "vector_length": int(network.expected_vector_length),
        }

    def _retired_unfreed_index(self, selector: Any) -> Optional[int]:
        """A slot that was retired (edge stopped routing) but whose drain
        timed out, so its params were never freed — /admin/unload on it is a
        RETRY of the drain, not an error. Name lookup scans all slots here
        because the live name map no longer carries retired names."""
        retryable = {
            index for index in self._retired if self.networks[index] is not None
        }
        if isinstance(selector, bool):
            return None
        if isinstance(selector, int):
            return selector if selector in retryable else None
        if isinstance(selector, str):
            by_name = [
                index for index in retryable
                if self.network_names[index] == selector
            ]
            if len(by_name) == 1:
                return by_name[0]
            if selector.isdigit() and int(selector) in retryable:
                return int(selector)
        return None

    def unload_network(
        self, selector: Any, timeout_s: float = 600.0
    ) -> Dict[str, Any]:
        """Retire a resident network (POST /admin/unload): new requests are
        refused immediately, in-flight ones finish, then the slot and its
        device memory are dropped. Network 0 (the daemon's identity) cannot
        be unloaded. If the drain timed out (drained=false), calling unload
        again on the same slot RETRIES the drain — the slot is never leaked
        permanently."""
        with self._admin_lock:
            retry_index = self._retired_unfreed_index(selector)
            if retry_index is not None:
                index = retry_index
            else:
                index = self.resolve_network_index({"network": selector})
                if index == 0:
                    raise ServingError(
                        "network 0 is the daemon's identity and cannot be "
                        "unloaded; unload is for hot-swapped additions"
                    )
                self._retired.add(index)  # the HTTP edge stops routing NOW
                self._rebuild_name_map()
        drained = self.batcher.retire_network(index, timeout_s=timeout_s)
        if drained:
            if self.network_unloader is not None:
                self.network_unloader(index)
            self.networks[index] = None
            LOGGER.info(
                "unloaded network %d (%s)", index, self.network_names[index]
            )
        else:
            LOGGER.warning(
                "network %d still has in-flight work after %gs; slot kept "
                "until its requests resolve", index, timeout_s,
            )
        return {
            "index": index,
            "name": self.network_names[index],
            "drained": bool(drained),
        }

    def health(self) -> Dict[str, Any]:
        import gance_tpu_torch

        payload = {
            "ok": not self.draining,
            "draining": self.draining,
            "version": gance_tpu_torch.__version__,
            "vector_length": int(self.network.expected_vector_length),
            "resolution": int(getattr(self.network, "resolution", 0)),
            "max_frames_per_request": self.frame_cap,
        }
        if len(self.networks) > 1:
            payload["networks"] = [
                (
                    {"index": i, "name": self.network_names[i], "retired": True}
                    if i in self._retired or n is None
                    else {
                        "index": i,
                        "name": self.network_names[i],
                        "vector_length": int(n.expected_vector_length),
                        "resolution": int(getattr(n, "resolution", 0)),
                        "max_frames_per_request": self.frame_caps[i],
                    }
                )
                for i, n in enumerate(self.networks)
            ]
        return payload

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout_s: float = 600.0) -> bool:
        """
        Graceful-shutdown half one: refuse new requests (HTTP 503, a
        retryable status for load balancers), wait for every live request
        to resolve and then for every response to be written. Returns False
        if the timeout expired with work still in flight (callers proceed to
        stop() either way; stop fails leftovers loudly). Idempotent.

        Departure from gance_tpu, whose drain returns once the batcher is
        idle: a large response could then still be on its way out when the
        server stops and the process exits.
        """
        if not self._draining.is_set():
            LOGGER.info(
                "synthesis daemon draining: %d live request(s)",
                self.batcher.live_requests(),
            )
        with self._responding_lock:
            # set under the lock: no request is admitted after this
            self._draining.set()
        deadline = time.monotonic() + timeout_s
        if not self.batcher.wait_idle(timeout_s):
            return False
        while self._responding:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)
        return True

    def start(self) -> "SynthesisDaemon":
        self._thread.start()
        LOGGER.info("synthesis daemon listening on port %d", self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=30)
        self.batcher.close()

    def __enter__(self) -> "SynthesisDaemon":
        return self.start()

    def __exit__(self, *_exc) -> None:
        self.stop()
