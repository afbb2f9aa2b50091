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
for CUDA on a host without it raises. A batch becomes frames through
`models/frames.py::frames`, which owns the rank, truncation, noise and
output-size rules for both model families. Every call resolves the
polyphase top block (GANCE_TPU_PHASE1024) anew, as JAX's runtime does.

Multi-device placement is JAX's: `SynthesisNetwork(mesh=)` places the params
on a ('data', 'model') mesh (copied to each device with a 'model' axis of 1,
tensor-parallel over each data row's model slots above 1:
`parallel/mesh.py::generator_param_sharding`) and splits every batch over
the data axis (padded to a multiple of it by repeating the last row, the
pads sliced off); `MultiNetwork` takes `mesh`, `device_per_network`
(network i wholly on local device i mod count) or `network_parallel` (every
network on its own device group, `parallel/network_parallel.py`), one at a
time. A mesh's frames reach the host through
`parallel/mesh.py::fetch_to_host`, all-gathered across processes.
"""

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# parse_network_paths is re-exported beside MultiNetwork, as gance_tpu's runtime does.
from gance_tpu_torch.models.pickle_loader import load_generator, parse_network_paths  # noqa: F401
from gance_tpu_torch.models.frames import Config, frames, prepare
from gance_tpu_torch.models.stylegan2 import DEFAULT_TRUNCATION_PSI, GeneratorConfig
from gance_tpu_torch.parallel.mesh import (
    _bucket_size,
    data_axis_size,
    fetch_to_host as _fetch_to_host,
    generator_param_sharding,
    local_devices,
)
from gance_tpu_torch.parallel.network_parallel import (
    NetworkParallelSynthesis,
    create_network_mesh,
)
from gance_tpu_torch.parallel.sharded_synthesis import run_sharded
from gance_tpu_torch.types import is_vector
from gance_tpu_torch.utils.device import params_to_device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.utils.profiling import count, span

Params = Dict[str, Any]

# The same knobs, names and defaults as gance_tpu's runtime.
DEFAULT_BATCH_SIZE = int(os.environ.get("GANCE_TPU_BATCH_SIZE", "8"))
DEFAULT_STREAM_LOOKAHEAD = int(os.environ.get("GANCE_TPU_STREAM_LOOKAHEAD", "2"))
DEFAULT_COMPUTE_DTYPE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}[os.environ.get("GANCE_TPU_COMPUTE_DTYPE", "float32").lower()]


def _pad_batch(data: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to `batch_size`; return (padded, real_count)."""
    real = data.shape[0]
    if real == batch_size:
        return data, real
    pad = [(0, batch_size - real)] + [(0, 0)] * (data.ndim - 1)
    return np.pad(data, pad), real


# A dispatched window: its frame count, its per-index groups as (images on
# their way to the host, stream positions), and one event per GPU it ran on
# that fires once that GPU's copies to the host are done.
Window = Tuple[int, List[Tuple[Any, List[int]]], List[torch.cuda.Event]]


def _window_in_order(window: Window, window_start: int) -> Iterator[np.ndarray]:
    """Wait for a dispatched window's copies and yield its frames in stream
    order (the spans close before the first frame goes to the caller)."""
    frames, groups, ready = window
    with span("runtime.await_window"):
        for event in ready:
            event.synchronize()
    with span("runtime.deliver"):
        out: List[Optional[np.ndarray]] = [None] * frames
        for images, positions in groups:
            host_images = _fetch_to_host(images)
            for row, position in enumerate(positions):
                out[position - window_start] = host_images[row]
    for image in out:
        assert image is not None
        yield image


@dataclass
class SynthesisNetwork:
    """A loaded generator: params resident on `device` + config + batched
    apply through `models/frames.py::frames`. `config` is a StyleGAN2
    `GeneratorConfig` or a `models/stylegan3.py::StyleGAN3Config`, whose
    network runs in fp32 on one device (no mesh)."""

    params: Params
    config: Config
    path: Optional[Path] = None
    truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI
    compute_dtype: torch.dtype = DEFAULT_COMPUTE_DTYPE
    output_side_length: Optional[int] = None
    # When set, params are placed on the mesh (tensor-parallel over a 'model'
    # axis above 1) and frame batches split over its 'data' axis (the device
    # is the mesh's first).
    mesh: Optional[Any] = None
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self) -> None:
        self._replicas: Optional[Dict[Tuple[torch.device, ...], Any]] = None
        self._data_axis = 1
        if self.mesh is not None:
            # the mesh's sharding policy knows StyleGAN2's params tree only
            if not isinstance(self.config, GeneratorConfig):
                raise ValueError("only a StyleGAN2 network runs on a mesh; StyleGAN3 runs on "
                                 "one device")
            self._replicas = generator_param_sharding(self.mesh, self.params)
            self._data_axis = data_axis_size(self.mesh)
            self.device = self.mesh.first_device
            # the first data row's params (a GroupParams on a 'model' axis)
            self.params = next(iter(self._replicas.values()))
            return
        self.device = resolve_device(self.device)
        # Params go to the device once and stay there for every call.
        self.params = params_to_device(self.params, self.device)
        self._prepared = prepare(self.params, self.config)

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

    def _frames(self, prepared: Any, batch: torch.Tensor) -> torch.Tensor:
        return frames(prepared, batch, self.config, truncation_psi=self.truncation_psi,
                      compute_dtype=self.compute_dtype,
                      output_side_length=self.output_side_length)

    def _on_mesh(self, batch: Union[np.ndarray, torch.Tensor]) -> Any:
        """The batch over the mesh's data axis, padded to a multiple of it by
        repeating the last row (the pads are sliced off at the fetch)."""
        batch = batch.cpu() if torch.is_tensor(batch) else torch.from_numpy(
            np.ascontiguousarray(batch, np.float32))
        n = batch.shape[0]
        pad = (-n) % self._data_axis
        if pad:
            batch = torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])
        side = self.output_side_length or self.config.resolution
        return run_sharded(self.mesh, self._replicas, batch, self._frames, (side, side, 3),
                           rows=n)

    @torch.inference_mode()
    def device_images_generic(self, batch: Union[np.ndarray, torch.Tensor]) -> Any:
        """(B, latent) z or (B, num_style_rows, dlatent) w+ -> (B, S, S, 3)
        uint8 on the device (queued, not synced); S is `output_side_length`,
        or the resolution. The rank decides: w+ skips the mapping network and
        truncation, since projection latents are final. On a mesh: the
        launched shards (`parallel/mesh.py::ShardedRows`)."""
        if self.mesh is not None:
            return self._on_mesh(batch)
        return self._frames(self._prepared, self._input(batch))

    device_images_from_vectors = device_images_generic
    device_images_from_matrices = device_images_generic

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


class _NetworkParallelMember:
    """
    One network's view of a `NetworkParallelSynthesis`, so that the indexed
    single-image surface works in network-parallel mode: its batches go
    through every network's group (the other groups' work is wasted, fine
    for an occasional call; the stream routes whole windows).
    """

    def __init__(self, serving: Any, index: int, path: Optional[Path]) -> None:
        self._serving = serving
        self.index = index
        self.path = path

    @property
    def expected_vector_length(self) -> int:
        return self._serving.config.latent_size

    @property
    def resolution(self) -> int:
        return self._serving.config.resolution

    def images_generic(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch)
        return self._serving.synthesize(batch, np.full((batch.shape[0],), self.index, dtype=int))

    # network-parallel frames are assembled on the host, so "device" images are host arrays
    device_images_generic = images_generic
    images_from_vectors = images_generic
    images_from_matrices = images_generic

    def create_image_vector(self, data: np.ndarray) -> np.ndarray:
        return self.images_generic(np.asarray(data).reshape(1, -1))[0]

    def create_image_matrix(self, data: np.ndarray) -> np.ndarray:
        return self.images_generic(np.asarray(data)[None])[0]

    def create_image_generic(self, data: np.ndarray) -> np.ndarray:
        return (
            self.create_image_vector(data) if is_vector(data) else self.create_image_matrix(data)
        )


NetworkLike = Union[SynthesisNetwork, FakeSynthesisNetwork, _NetworkParallelMember]


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
    Networks addressed by index, all resident once loaded; entering the
    context manager loads them and leaving it drops them. By default every
    network lives on `device`; `mesh`, `device_per_network` and
    `network_parallel` place them as JAX's do, one at a time.
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
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        _preloaded: Optional[List[NetworkLike]] = None,
    ) -> None:
        if sum([mesh is not None, device_per_network, network_parallel]) > 1:
            raise ValueError(
                "mesh, device_per_network, and network_parallel are mutually exclusive"
            )
        self.network_paths = [Path(p) for p in network_paths]
        self._truncation_psi = truncation_psi
        self._compute_dtype = compute_dtype
        self._output_side_length = output_side_length
        self._device = device
        self._mesh = mesh
        self._device_per_network = device_per_network
        self._network_parallel = network_parallel
        # the devices device_per_network and network_parallel place networks
        # on (default: every local device of `device`); may repeat a device
        self._devices = devices
        self._np_serving: Optional[Any] = None
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
        if self._networks is None and self._network_parallel:
            LOGGER.info("Network-parallel synthesis: %d networks resident on a "
                        "('network', 'data') mesh", len(self.network_paths))
            self._np_serving = NetworkParallelSynthesis.from_pkls(
                self.network_paths, truncation_psi=self._truncation_psi,
                compute_dtype=self._compute_dtype,
                output_side_length=self._output_side_length,
                mesh=create_network_mesh(len(self.network_paths), devices=self._devices,
                                         device=self._device),
            )
            self._networks = [_NetworkParallelMember(self._np_serving, i, p)
                              for i, p in enumerate(self.network_paths)]
            return
        if self._networks is None:
            LOGGER.info("Loading %d networks", len(self.network_paths))
            devices = None
            if self._device_per_network:
                devices = ([torch.device(d) for d in self._devices] if self._devices
                           else local_devices(self._device))
                LOGGER.info("One network per device over %d devices", len(devices))
            self._networks = [
                SynthesisNetwork.from_pkl(
                    p, truncation_psi=self._truncation_psi, compute_dtype=self._compute_dtype,
                    output_side_length=self._output_side_length, mesh=self._mesh,
                    device=devices[i % len(devices)] if devices else self._device,
                )
                for i, p in enumerate(self.network_paths)
            ]

    def unload(self) -> None:
        """Drop all params (frees device memory)."""
        self._networks = None
        self._np_serving = None

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
        if self._np_serving is not None:
            # network-parallel: whole windows route through every network's
            # group; window i+1 launches before window i is fetched
            serving = self._np_serving
            window_size = batch_size * max(int(lookahead), 1)
            handle = None
            for start in range(0, n, window_size):
                end = min(start + window_size, n)
                launched = serving.dispatch(frame_data[start:end], network_indices[start:end],
                                            batch_size=batch_size)
                if handle is not None:
                    yield from serving.gather(handle)
                handle = launched
            if handle is not None:
                yield from serving.gather(handle)
            return

        # Batches over a mesh stay divisible by its data axis, the cap too:
        # batch_size rounds down to a data-axis multiple (up only when it is
        # below the data axis, the smallest batch that fills it).
        data_axis = data_axis_size(self._mesh)
        if data_axis > 1:
            batch_size = max(data_axis, batch_size - batch_size % data_axis)
        window_size = batch_size * max(int(lookahead), 1)

        def dispatch_window(start: int, end: int) -> Window:
            """Group [start:end) by index, queue each group and its copy to the host."""
            with span("runtime.dispatch_window"):
                window_indices = network_indices[start:end]
                groups: List[Tuple[Any, List[int]]] = []
                gpus: Dict[torch.device, None] = {}
                for index in dict.fromkeys(int(i) for i in window_indices):
                    positions = [start + int(o) for o in np.nonzero(window_indices == index)[0]]
                    # Full batches first; only the remainder pays pad waste.
                    for chunk_start in range(0, len(positions), batch_size):
                        chunk_positions = positions[chunk_start : chunk_start + batch_size]
                        rows = _bucket_size(len(chunk_positions), batch_size, multiple=data_axis)
                        padded, real = _pad_batch(frame_data[chunk_positions], rows)
                        with span("runtime.forward"):
                            images = networks[index].device_images_generic(padded)
                        if torch.is_tensor(images) and images.is_cuda:
                            gpus[images.device] = None
                        with span("runtime.host_copy"):
                            groups.append((_start_host_copy(images, real), chunk_positions))
                        count("runtime.forwards")
                        count("runtime.rows_real", real)
                        count("runtime.rows_dispatched", rows)
                ready = []
                for gpu in gpus:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(gpu))
                    ready.append(event)
            count("runtime.windows")
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
