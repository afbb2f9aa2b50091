"""
Batched synthesis runtime: loaded networks with their params resident on one
device, and a multi-network streaming front end.

The counterpart of gance_tpu/synthesis/runtime.py, with the same public
surface: `SynthesisNetwork` (from_pkl, images_from_vectors / _matrices /
_generic, device_images_*, create_image_*), `FakeSynthesisNetwork` and
`MultiNetwork` (load/unload, context manager, synthesize_stream,
synthesize_all). Inputs are numpy z (B, 512) or w+ (B, 18, 512); outputs are
uint8 NHWC frames. The inference constants are the reference's: truncation
psi=1.2 on the vectors path, constant noise buffers, and no mapping or
truncation on the matrices path.

Entry points run on `device="cuda"` unless the caller asks for the CPU; asking
for CUDA on a host without it raises. Every call resolves the polyphase top
block (GANCE_TPU_PHASE1024) anew, as JAX's runtime does. With an
`output_side_length` other than the resolution, frames are rendered as float,
resized on the device (`resize_images`, JAX's bicubic) and then quantised;
otherwise the uint8 output is fused into synthesis. Multi-device placement
(`mesh`, `device_per_network`, `network_parallel`) is not ported yet and
raises NotImplementedError.
"""

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# parse_network_paths is re-exported beside MultiNetwork, as gance_tpu's runtime does.
from gance_tpu_torch.models.pickle_loader import load_generator, parse_network_paths  # noqa: F401
from gance_tpu_torch.models.stylegan2 import (
    DEFAULT_TRUNCATION_PSI,
    GeneratorConfig,
    generator_apply,
    images_to_uint8,
    resize_images,
    synthesis_apply,
)
from gance_tpu_torch.types import is_vector
from gance_tpu_torch.utils.device import resolve_device
from gance_tpu_torch.utils.logging import LOGGER

Params = Dict[str, Any]

# The same knobs, names and defaults as gance_tpu's runtime.
DEFAULT_BATCH_SIZE = int(os.environ.get("GANCE_TPU_BATCH_SIZE", "8"))
DEFAULT_STREAM_LOOKAHEAD = int(os.environ.get("GANCE_TPU_STREAM_LOOKAHEAD", "2"))
DEFAULT_COMPUTE_DTYPE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}[os.environ.get("GANCE_TPU_COMPUTE_DTYPE", "float32").lower()]

_MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"


def params_to_device(params: Any, device: torch.device) -> Any:
    """A params tree of numpy arrays (or tensors) -> float32 tensors on `device`,
    copied, so the tree never aliases the caller's arrays."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    if torch.is_tensor(params):
        return params.to(device=device, dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(params, dtype=np.float32)).to(device)


def _fetch_to_host(images: Any) -> np.ndarray:
    return images.cpu().numpy() if torch.is_tensor(images) else np.asarray(images)


def _pad_batch(data: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to `batch_size`; return (padded, real_count)."""
    real = data.shape[0]
    if real == batch_size:
        return data, real
    pad = [(0, batch_size - real)] + [(0, 0)] * (data.ndim - 1)
    return np.pad(data, pad), real


def _bucket_size(real: int, batch_size: int, multiple: int = 1) -> int:
    """Smallest `multiple`·2^k >= `real`, capped at `batch_size`: bounds pad
    waste on partial batches at under 2x. The serving batcher buckets with
    `multiple` 8; the stream keeps 1."""
    size = multiple
    while size < real and size < batch_size:
        size *= 2
    return min(size, batch_size)


# A dispatched window: its frame count, its per-index groups as (images on
# their way to the host, stream positions), and an event that fires once every
# group's copy to the host is done (None when nothing ran on a GPU).
Window = Tuple[int, List[Tuple[Any, List[int]]], Optional[torch.cuda.Event]]


def _window_in_order(window: Window, window_start: int) -> Iterator[np.ndarray]:
    """Wait for a dispatched window's copies and yield its frames in stream order."""
    count, groups, ready = window
    if ready is not None:
        ready.synchronize()
    out: List[Optional[np.ndarray]] = [None] * count
    for images, positions in groups:
        host_images = _fetch_to_host(images)
        for row, position in enumerate(positions):
            out[position - window_start] = host_images[row]
    for image in out:
        assert image is not None
        yield image


@dataclass
class SynthesisNetwork:
    """A loaded generator: params resident on `device` + config + batched apply."""

    params: Params
    config: GeneratorConfig
    path: Optional[Path] = None
    truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI
    compute_dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE
    output_side_length: Optional[int] = None
    mesh: Optional[Any] = None
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(f"mesh placement is not ported yet: {_MULTI_DEVICE_ITEM}")
        self.device = resolve_device(self.device)
        # Params go to the device once and stay there for every call.
        self.params = params_to_device(self.params, self.device)

    @classmethod
    def from_pkl(
        cls,
        path: Path,
        truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI,
        compute_dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE,
        output_side_length: Optional[int] = None,
        mesh: Optional[Any] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "SynthesisNetwork":
        return cls.from_staged(
            cls.stage_pkl(path), path, truncation_psi=truncation_psi,
            compute_dtype=compute_dtype, output_side_length=output_side_length,
            mesh=mesh, device=device,
        )

    @classmethod
    def stage_pkl(cls, path: Path) -> Tuple[Params, GeneratorConfig]:
        """The host-side half of `from_pkl`: parse the pickle into numpy arrays."""
        return load_generator(Path(path))

    @classmethod
    def from_staged(
        cls, staged: Tuple[Params, GeneratorConfig], path: Path, **kwargs: Any
    ) -> "SynthesisNetwork":
        """Construct (and place on the device) a network from `stage_pkl` output."""
        params, config = staged
        return cls(params=params, config=config, path=Path(path), **kwargs)

    @property
    def expected_vector_length(self) -> int:
        return self.config.latent_size

    @property
    def resolution(self) -> int:
        return self.config.resolution

    def _input(self, batch: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """The batch as float32 on the device. A tensor (the serving batcher's
        input, already copied from pinned memory) is taken as it is."""
        if torch.is_tensor(batch):
            return batch.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(batch, np.float32)).to(self.device)

    @property
    def _needs_resize(self) -> bool:
        return self.output_side_length not in (None, self.config.resolution)

    def _finish(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 frames as they leave: resized from float when asked, else as rendered."""
        if self._needs_resize:
            return images_to_uint8(resize_images(images, self.output_side_length))
        return images

    @torch.inference_mode()
    def device_images_from_vectors(self, z_batch: np.ndarray) -> torch.Tensor:
        """(B, latent) z -> (B, S, S, 3) uint8 on the device (queued, not synced);
        S is `output_side_length`, or the resolution."""
        return self._finish(generator_apply(
            self.params, self._input(z_batch), self.config,
            truncation_psi=self.truncation_psi, noise_mode="const",
            compute_dtype=self.compute_dtype,
            uint8_output=not self._needs_resize,
        ))

    @torch.inference_mode()
    def device_images_from_matrices(self, dlatent_batch: np.ndarray) -> torch.Tensor:
        """(B, num_style_rows, dlatent) w+ -> uint8 images on the device. Skips the
        mapping network and truncation: projection latents are final."""
        return self._finish(synthesis_apply(
            self.params, self._input(dlatent_batch), self.config, noise_mode="const",
            compute_dtype=self.compute_dtype,
            uint8_output=not self._needs_resize,
        ))

    def device_images_generic(self, batch: np.ndarray) -> torch.Tensor:
        """Dispatch on input rank: (B, V) -> vectors, (B, R, V) -> matrices."""
        batch = np.asarray(batch)
        if batch.ndim == 2:
            return self.device_images_from_vectors(batch)
        if batch.ndim == 3:
            return self.device_images_from_matrices(batch)
        raise ValueError(f"Cannot dispatch batch of shape {batch.shape}")

    def images_from_vectors(self, z_batch: np.ndarray) -> np.ndarray:
        return _fetch_to_host(self.device_images_from_vectors(z_batch))

    def images_from_matrices(self, dlatent_batch: np.ndarray) -> np.ndarray:
        return _fetch_to_host(self.device_images_from_matrices(dlatent_batch))

    def images_generic(self, batch: np.ndarray) -> np.ndarray:
        return _fetch_to_host(self.device_images_generic(batch))

    # ---- single-image compatibility surface ----

    def create_image_vector(self, data: np.ndarray) -> np.ndarray:
        return self.images_from_vectors(np.asarray(data).reshape(1, -1))[0]

    def create_image_matrix(self, data: np.ndarray) -> np.ndarray:
        return self.images_from_matrices(np.asarray(data)[None, ...])[0]

    def create_image_generic(self, data: np.ndarray) -> np.ndarray:
        return (
            self.create_image_vector(data) if is_vector(data) else self.create_image_matrix(data)
        )


class FakeSynthesisNetwork:
    """
    Deterministic fake backend for tests: images encode the mean of the input,
    so a test can follow data flow without a real model.
    """

    def __init__(self, resolution: int = 64, expected_vector_length: int = 512) -> None:
        self.config = GeneratorConfig(resolution=resolution)
        self._vector_length = expected_vector_length
        self.path: Optional[Path] = None
        self.resolution = resolution

    @property
    def expected_vector_length(self) -> int:
        return self._vector_length

    def _render(self, batch: np.ndarray) -> np.ndarray:
        mean = batch.reshape(batch.shape[0], -1).mean(axis=1)
        value = np.clip((mean * 37 + 128), 0, 255).astype(np.uint8)
        return np.broadcast_to(
            value[:, None, None, None], (batch.shape[0], self.resolution, self.resolution, 3)
        ).copy()

    def images_from_vectors(self, z_batch: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(z_batch))

    def images_from_matrices(self, dlatent_batch: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(dlatent_batch))

    def images_generic(self, batch: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(batch))

    def device_images_generic(self, batch: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(batch))

    def create_image_vector(self, data: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(data).reshape(1, -1))[0]

    def create_image_matrix(self, data: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(data)[None])[0]

    def create_image_generic(self, data: np.ndarray) -> np.ndarray:
        return self._render(np.asarray(data).reshape(1, *np.asarray(data).shape))[0]


NetworkLike = Union[SynthesisNetwork, FakeSynthesisNetwork]


def _start_host_copy(images: Any, rows: int) -> Any:
    """Queue the copy of a group's first `rows` frames into pinned host memory
    (GPU tensors); other results pass through."""
    if torch.is_tensor(images) and images.is_cuda:
        host = torch.empty((rows, *images.shape[1:]), dtype=images.dtype, pin_memory=True)
        host.copy_(images[:rows], non_blocking=True)
        return host
    return images


class MultiNetwork:
    """
    Networks addressed by index, all resident on one device once loaded;
    entering the context manager loads them and leaving it drops them.
    """

    def __init__(
        self,
        network_paths: Sequence[Path],
        load: bool = False,
        truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI,
        compute_dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE,
        output_side_length: Optional[int] = None,
        mesh: Optional[Any] = None,
        device_per_network: bool = False,
        network_parallel: bool = False,
        device: Union[str, torch.device] = "cuda",
        _preloaded: Optional[List[NetworkLike]] = None,
    ) -> None:
        for name, value in (
            ("mesh", mesh is not None),
            ("device_per_network", device_per_network),
            ("network_parallel", network_parallel),
        ):
            if value:
                raise NotImplementedError(f"{name} is not ported yet: {_MULTI_DEVICE_ITEM}")
        self.network_paths = [Path(p) for p in network_paths]
        self._truncation_psi = truncation_psi
        self._compute_dtype = compute_dtype
        self._output_side_length = output_side_length
        self._device = device
        self._networks: Optional[List[NetworkLike]] = _preloaded
        if load and self._networks is None:
            self.load()

    @classmethod
    def from_networks(cls, networks: Sequence[NetworkLike]) -> "MultiNetwork":
        """Build from already-constructed networks (fakes included, for tests)."""
        return cls(
            network_paths=[n.path or Path(f"fake_{i}") for i, n in enumerate(networks)],
            _preloaded=list(networks),
        )

    def load(self) -> None:
        if self._networks is None:
            LOGGER.info("Loading %d networks", len(self.network_paths))
            self._networks = [
                SynthesisNetwork.from_pkl(
                    p, truncation_psi=self._truncation_psi, compute_dtype=self._compute_dtype,
                    output_side_length=self._output_side_length, device=self._device,
                )
                for p in self.network_paths
            ]

    def unload(self) -> None:
        """Drop all params (frees device memory)."""
        self._networks = None

    def __enter__(self) -> "MultiNetwork":
        self.load()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.unload()

    def _require_loaded(self) -> List[NetworkLike]:
        if self._networks is None:
            raise ValueError("Networks are not loaded; call load() or use as a context manager.")
        return self._networks

    def __len__(self) -> int:
        return len(self.network_paths)

    @property
    def network_indices(self) -> List[int]:
        return list(range(len(self.network_paths)))

    @property
    def expected_vector_length(self) -> int:
        return self._require_loaded()[0].expected_vector_length

    @property
    def resolution(self) -> int:
        return self._require_loaded()[0].resolution

    def network(self, index: int) -> NetworkLike:
        return self._require_loaded()[index]

    def indexed_create_image_vector(self, index: int, data: np.ndarray) -> np.ndarray:
        return self._require_loaded()[index].create_image_vector(data)

    def indexed_create_image_matrix(self, index: int, data: np.ndarray) -> np.ndarray:
        return self._require_loaded()[index].create_image_matrix(data)

    def indexed_create_image_generic(self, index: int, data: np.ndarray) -> np.ndarray:
        return self._require_loaded()[index].create_image_generic(data)

    def synthesize_stream(
        self,
        frame_data: np.ndarray,
        network_indices: Optional[np.ndarray] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
        lookahead: int = DEFAULT_STREAM_LOOKAHEAD,
    ) -> Iterator[np.ndarray]:
        """
        Synthesize frames in order, yielding uint8 (H, W, 3) images one at a
        time while computing in batches.

        Frames go in windows of `lookahead * batch_size`. Within a window they
        are grouped by network index; each group runs in full `batch_size`
        chunks plus one remainder padded to a power of two (`_bucket_size`),
        and the outputs scatter back to stream order. Window i+1's work is
        queued on the device stream before the host waits for window i, whose
        frames were queued for copy into pinned host memory right after its
        compute; so the device computes window i+1 while the host consumes
        window i.

        :param frame_data: (N, V) vectors or (N, R, V) matrices.
        :param network_indices: (N,) ints into this MultiNetwork; None -> zeros.
        """
        networks = self._require_loaded()
        frame_data = np.asarray(frame_data)
        n = frame_data.shape[0]
        if network_indices is None:
            network_indices = np.zeros((n,), dtype=int)
        network_indices = np.asarray(network_indices).astype(int)
        if network_indices.shape[0] < n:
            LOGGER.warning(
                "synthesize_stream: %d frames but %d network indices; "
                "truncating to the shorter stream", n, network_indices.shape[0],
            )
            n = network_indices.shape[0]
            frame_data = frame_data[:n]
        if n and (network_indices[:n].min() < 0 or network_indices[:n].max() >= len(networks)):
            raise ValueError(
                f"network_indices out of range [0, {len(networks)}): "
                f"[{network_indices[:n].min()}, {network_indices[:n].max()}]"
            )
        window_size = batch_size * max(int(lookahead), 1)

        def dispatch_window(start: int, end: int) -> Window:
            """Group [start:end) by index, queue each group and its copy to the host."""
            window_indices = network_indices[start:end]
            groups: List[Tuple[Any, List[int]]] = []
            on_gpu = False
            for index in dict.fromkeys(int(i) for i in window_indices):
                positions = [start + int(o) for o in np.nonzero(window_indices == index)[0]]
                # Full batches first; only the remainder pays pad waste.
                for chunk_start in range(0, len(positions), batch_size):
                    chunk_positions = positions[chunk_start : chunk_start + batch_size]
                    padded, real = _pad_batch(
                        frame_data[chunk_positions],
                        _bucket_size(len(chunk_positions), batch_size),
                    )
                    images = networks[index].device_images_generic(padded)
                    on_gpu = on_gpu or (torch.is_tensor(images) and images.is_cuda)
                    groups.append((_start_host_copy(images, real), chunk_positions))
            ready = None
            if on_gpu:
                ready = torch.cuda.Event()
                ready.record()
            return end - start, groups, ready

        pending: Optional[Window] = None
        pending_start = 0
        for start in range(0, n, window_size):
            window = dispatch_window(start, min(start + window_size, n))
            if pending is not None:
                yield from _window_in_order(pending, pending_start)
                pending_start += pending[0]
            pending = window
        if pending is not None:
            yield from _window_in_order(pending, pending_start)

    def synthesize_all(
        self,
        frame_data: np.ndarray,
        network_indices: Optional[np.ndarray] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
        lookahead: int = DEFAULT_STREAM_LOOKAHEAD,
    ) -> np.ndarray:
        """Materialize the full (N, R, R, 3) uint8 stack (small runs / tests)."""
        return np.stack(
            list(self.synthesize_stream(frame_data, network_indices, batch_size, lookahead))
        )
