"""
Python client for the port's online synthesis daemon (daemon.py), the
counterpart of gance_tpu/serving/client.py: the same class, methods and wire
format, so either package's client talks to either package's daemon.

Stdlib-only (urllib). Raises `ServingClientError` carrying the server's JSON
error message for 4xx/5xx, so callers see "latent length 511 != network's
512" rather than a bare HTTPError.

    client = ServingClient("http://127.0.0.1:8799")
    client.health()["resolution"]
    images = client.synthesize(seeds=[0, 1, 2])            # (3, H, W, 3) uint8
    images = client.synthesize(count=8, seed=42, network=1)
    images = client.synthesize(dlatents=wplus)             # (B, R, V) float
    png    = client.synthesize_png(seeds=[7])              # encoded bytes
"""

import base64
import io
import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np


class ServingClientError(RuntimeError):
    """An HTTP error from the daemon, carrying its JSON 'error' message."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServingClient:
    """One daemon endpoint. Thread-safe (no shared mutable state; urllib
    opens a connection per call, matching the daemon's thread-per-request
    server)."""

    def __init__(self, base_url: str, timeout_s: float = 600.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    # ---- endpoints ----

    def health(self) -> Dict[str, Any]:
        return self._get_json("/healthz")

    def stats(self) -> Dict[str, Any]:
        return self._get_json("/stats")

    def synthesize(
        self,
        latents: Optional[np.ndarray] = None,
        dlatents: Optional[np.ndarray] = None,
        seeds: Optional[Sequence[int]] = None,
        count: Optional[int] = None,
        seed: Optional[int] = None,
        network: Optional[Union[int, str]] = None,
    ) -> np.ndarray:
        """(B, H, W, 3) uint8 images for exactly one latent source (the same
        contract as the POST body; see daemon.py's module docstring)."""
        body = self._body(latents, dlatents, seeds, count, seed, network)
        blob, _headers = self._post_synthesize(body)
        return np.load(io.BytesIO(blob))

    def synthesize_png(
        self,
        latents: Optional[np.ndarray] = None,
        dlatents: Optional[np.ndarray] = None,
        seeds: Optional[Sequence[int]] = None,
        network: Optional[Union[int, str]] = None,
    ) -> bytes:
        """PNG bytes for exactly one image."""
        body = self._body(latents, dlatents, seeds, None, None, network)
        body["format"] = "png"
        blob, _headers = self._post_synthesize(body)
        return blob

    def synthesize_compressed(
        self,
        latents: Optional[np.ndarray] = None,
        dlatents: Optional[np.ndarray] = None,
        seeds: Optional[Sequence[int]] = None,
        count: Optional[int] = None,
        seed: Optional[int] = None,
        network: Optional[Union[int, str]] = None,
        format: str = "png-zip",  # noqa: A002 - mirrors the HTTP field name
        fps: float = 30.0,
    ) -> bytes:
        """Compressed frame egress: "png-zip" (a ZIP of lossless PNGs, one
        per frame) or "avi" (a video at `fps`). At 1024px the npy response
        is about 3 MB a frame; these formats trade the server's encode time
        for fewer bytes."""
        if format not in ("png-zip", "avi"):
            raise ValueError(f"format must be 'png-zip' or 'avi', got {format!r}")
        body = self._body(latents, dlatents, seeds, count, seed, network)
        body["format"] = format
        if format == "avi":
            body["fps"] = float(fps)
        blob, _headers = self._post_synthesize(body)
        return blob

    def synthesize_audio(
        self,
        wav: Union[bytes, str, Any],
        fps: float = 30.0,
        alpha: float = 0.5,
        fft_roll: bool = False,
        networks: Optional[Sequence[Union[int, str]]] = None,
        plan: bool = False,
        format: str = "npy",  # noqa: A002 - mirrors the HTTP field name
        projection: Optional[str] = None,
        blend_depth: Optional[int] = None,
        overlay: Optional[Dict[str, Any]] = None,
    ) -> Union[np.ndarray, Dict[str, Any], bytes]:
        """Music -> frames, online (POST /synthesize_audio): the server runs
        the reference's noise-blend transform on the WAV and routes each
        frame to the network its loudness selects from `networks` (default:
        every live network). `wav` is raw WAV bytes or a Path. With
        plan=True, returns the routing plan dict instead of rendering. With
        format="avi", returns playable video BYTES — the frames with the
        posted audio muxed in server-side (the complete reference
        deliverable from one request). With `projection` (a handle from
        register_projection) this is the FLAGSHIP transform: the spectrogram
        blends into the first `blend_depth` style rows of the registered
        final latents and fps must be an integer multiple of the
        projection's fps."""
        if not isinstance(wav, (bytes, bytearray)):
            with open(wav, "rb") as handle:
                wav = handle.read()
        body: Dict[str, Any] = {
            "wav_base64": base64.b64encode(bytes(wav)).decode(),
            "fps": float(fps),
            "alpha": float(alpha),
            "fft_roll": bool(fft_roll),
        }
        if format != "npy":
            body["format"] = format
        if networks is not None:
            body["networks"] = list(networks)
        if projection is not None:
            body["projection"] = str(projection)
        if blend_depth is not None:
            body["blend_depth"] = int(blend_depth)
        if overlay is not None:
            # {"phash_distance", "bbox_distance", "track_length"} (+ optional
            # "detection_side", "smoothing"): composites the registered
            # projection's target frames into the avi via the eye tracker
            body["overlay"] = dict(overlay)
        if plan:
            body["plan"] = True
            return self._post_json("/synthesize_audio", body)
        blob, _headers = self._post(self.base_url + "/synthesize_audio", body)
        return blob if format == "avi" else np.load(io.BytesIO(blob))

    def register_projection(
        self,
        path: Optional[str] = None,
        final_latents: Optional[np.ndarray] = None,
        projection_fps: Optional[float] = None,
        name: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Make a projection file's final latents resident server-side
        (POST /admin/register_projection) so synthesize_audio can blend
        against them by handle. Either `path` (server-local HDF5) or
        `final_latents` ((frames, rows, V) array) + `projection_fps` +
        `name`."""
        body: Dict[str, Any] = {}
        if name is not None:
            body["name"] = str(name)
        if path is not None:
            body["path"] = str(path)
        if final_latents is not None:
            buffer = io.BytesIO()
            np.save(buffer, np.asarray(final_latents, np.float32))
            body["final_latents_base64"] = base64.b64encode(
                buffer.getvalue()
            ).decode()
            if projection_fps is not None:
                body["projection_fps"] = float(projection_fps)
        return self._post_json("/admin/register_projection", body)

    def unregister_projection(self, name: str) -> Dict[str, Any]:
        return self._post_json("/admin/unregister_projection", {"name": name})

    def projections(self) -> Dict[str, Any]:
        """Registered projections (GET /projections)."""
        return self._get_json("/projections")

    def load_network(self, path: str) -> Dict[str, Any]:
        """Hot-add a resident network on the server from a pickle path
        (zero-downtime model rollout; POST /admin/load). Returns the new
        slot: {"index", "name", "resolution", "vector_length"}."""
        return self._post_json("/admin/load", {"path": str(path)})

    def unload_network(self, network: Union[int, str]) -> Dict[str, Any]:
        """Retire a resident network by index or name (POST /admin/unload):
        new requests are refused at once, in-flight ones finish, then the
        slot's device memory frees."""
        return self._post_json("/admin/unload", {"network": network})

    # ---- plumbing ----

    @staticmethod
    def _body(
        latents: Optional[np.ndarray],
        dlatents: Optional[np.ndarray],
        seeds: Optional[Sequence[int]],
        count: Optional[int],
        seed: Optional[int],
        network: Optional[Union[int, str]],
    ) -> Dict[str, Any]:
        if seed is not None and count is None:
            raise ValueError(
                "'seed' seeds the server-side RandomState of the 'count' "
                "source — pass count=N with it (seeds=[...] pins one seed "
                "per frame instead)"
            )
        body: Dict[str, Any] = {}
        if latents is not None:
            body["latents"] = np.asarray(latents, np.float32).tolist()
        if dlatents is not None:
            body["dlatents"] = np.asarray(dlatents, np.float32).tolist()
        if seeds is not None:
            body["seeds"] = [int(s) for s in seeds]
        if count is not None:
            body["count"] = int(count)
            if seed is not None:
                body["seed"] = int(seed)
        if network is not None:
            body["network"] = network
        return body

    def _post_json(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        blob, _headers = self._post(self.base_url + path, body)
        return json.loads(blob)

    def _get_json(self, path: str) -> Dict[str, Any]:
        try:
            with urllib.request.urlopen(
                self.base_url + path, timeout=self.timeout_s
            ) as response:
                return json.loads(response.read())
        except urllib.error.HTTPError as error:
            raise self._wrap(error) from error

    def _post(self, url: str, body: Dict[str, Any]):
        request = urllib.request.Request(
            url,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(request, timeout=self.timeout_s) as response:
                return response.read(), dict(response.headers)
        except urllib.error.HTTPError as error:
            raise self._wrap(error) from error

    def _post_synthesize(self, body: Dict[str, Any]):
        return self._post(self.base_url + "/synthesize", body)

    @staticmethod
    def _wrap(error: "urllib.error.HTTPError") -> ServingClientError:
        try:
            message = json.loads(error.read())["error"]
        except Exception:  # pylint: disable=broad-except
            message = str(error)
        return ServingClientError(error.code, message)
