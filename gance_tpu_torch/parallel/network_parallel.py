"""
Network-parallel synthesis: N networks resident on N device groups at once,
the counterpart of gance_tpu/parallel/network_parallel.py.

The mesh has a 'network' axis and a 'data' axis: network i's params live on
the devices of row i, and its frames are data-parallel over that row. Each
call routes frames to their networks on the host (gather by index, pad to a
bucketed group size, scatter back to stream order) exactly as JAX's does,
then launches every (network, data slot) cell this process owns from the
calling thread, each on its device. Where JAX runs one SPMD program per
dispatch, the port launches the cells one after another; devices run them
concurrently. Across processes the cells of the other processes arrive
through one all_gather per dispatch (`gather`).

All networks must share one architecture. Params are stacked on the host
first (never on one device), then each network's go to its own devices.
"""

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gance_tpu_torch.models.frames import frames
from gance_tpu_torch.models.pickle_loader import load_generator
from gance_tpu_torch.models.stylegan2 import (
    DEFAULT_TRUNCATION_PSI,
    GeneratorConfig,
    resolve_phase_top_block,
)
from gance_tpu_torch.parallel.mesh import (
    Mesh,
    _bucket_size,
    _object_grid,
    all_gather_host,
    global_devices,
    shard_slices,
)
from gance_tpu_torch.utils.device import params_to_device

Params = Dict[str, Any]


def create_network_mesh(
    n_networks: int,
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Mesh:
    """
    A ('network', 'data') mesh: one device group per network, frames within
    a group data-parallel, over the largest prefix of the device slots
    divisible by n_networks. `devices` / `device` as in `create_mesh`.
    """
    slots = global_devices(devices, device)
    if n_devices is not None:
        slots = slots[:n_devices]
    per = len(slots) // n_networks
    if per < 1:
        raise ValueError(
            f"{n_networks} networks need at least {n_networks} devices; have {len(slots)}"
        )
    return Mesh(_object_grid(slots[: n_networks * per], (n_networks, per)), ("network", "data"))


def _leaves(tree: Params, prefix: str = "") -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            out.extend(_leaves(tree[key], path))
        else:
            out.append((path, tree[key]))
    return out


def stack_network_params(params_list: Sequence[Params]) -> Params:
    """
    Stack per-network param trees along a new leading 'network' axis, in host
    memory (numpy): the stack holds every network's params at once, which no
    single device has to. All trees must share structure and leaf shapes.
    """
    first = [path for path, _ in _leaves(params_list[0])]
    for i, tree in enumerate(params_list[1:], start=1):
        if [path for path, _ in _leaves(tree)] != first:
            raise ValueError(
                f"Network {i} has a different param structure than network 0 — "
                "network-parallel serving requires one shared architecture"
            )

    def stack(*nodes: Any) -> Any:
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return np.stack([np.asarray(n.detach().cpu() if torch.is_tensor(n) else n)
                         for n in nodes])

    return stack(*params_list)


def _unstack(stacked: Params, index: int) -> Params:
    if isinstance(stacked, dict):
        return {k: _unstack(v, index) for k, v in stacked.items()}
    return stacked[index]


class NetworkParallelSynthesis:
    """
    All-networks-resident synthesis over a ('network', 'data') mesh.

    `synthesize(frame_data, network_indices)` is the stream-order surface
    (routing, padding and scatter here); `synthesize_grouped` is the
    (N, G, ...) -> (N, G, S, S, 3) primitive.
    """

    def __init__(
        self,
        params_list: Sequence[Params],
        config: GeneratorConfig,
        mesh: Optional[Mesh] = None,
        truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI,
        compute_dtype: torch.dtype = torch.float32,
        phase_top_block_mode: Optional[bool] = None,
        output_side_length: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.n_networks = len(params_list)
        if self.n_networks < 1:
            raise ValueError("Need at least one network")
        self.config = config
        self.mesh = mesh if mesh is not None else create_network_mesh(self.n_networks,
                                                                      device=device)
        if self.mesh.shape.get("network") != self.n_networks:
            raise ValueError(
                f"Mesh 'network' axis {self.mesh.shape.get('network')} != "
                f"{self.n_networks} networks"
            )
        self.data_axis = self.mesh.shape.get("data", 1)
        self._truncation_psi = truncation_psi
        self._compute_dtype = compute_dtype
        self._phase_mode = phase_top_block_mode
        self.output_side_length = output_side_length

        stacked = stack_network_params(list(params_list))
        # each network's params once on each of its local devices
        self._params: Dict[Tuple[int, torch.device], Params] = {}
        for (i, _), slot in np.ndenumerate(self.mesh.devices):
            if self.mesh.is_local(slot) and (i, slot.device) not in self._params:
                self._params[(i, slot.device)] = params_to_device(_unstack(stacked, i),
                                                                  slot.device)

    @classmethod
    def from_pkls(cls, paths: Sequence[Path], **kwargs: Any) -> "NetworkParallelSynthesis":
        loaded = [load_generator(Path(p)) for p in paths]
        params_list = [params for params, _ in loaded]
        config = loaded[0][1]
        for path, (_, other) in zip(paths[1:], loaded[1:]):
            if other != config:
                raise ValueError(
                    f"{path} has architecture {other} != {config} — "
                    "network-parallel serving requires one shared architecture"
                )
        return cls(params_list, config, **kwargs)

    # ---- the grouped primitive ----

    def _resolved_phase_mode(self) -> bool:
        """Resolved per call, so GANCE_TPU_PHASE1024 flips take effect."""
        if self._phase_mode is not None:
            return self._phase_mode
        return resolve_phase_top_block(self.config)

    @property
    def output_resolution(self) -> int:
        return self.output_side_length or self.config.resolution

    def _launch_grouped(self, grouped: np.ndarray) -> "_GroupedFrames":
        grouped = np.asarray(grouped)
        if grouped.shape[0] != self.n_networks:
            raise ValueError(f"Leading axis {grouped.shape[0]} != {self.n_networks} networks")
        if grouped.shape[1] % self.data_axis:
            raise ValueError(
                f"Group size {grouped.shape[1]} must divide by the data axis ({self.data_axis})"
            )
        phase_mode = self._resolved_phase_mode()
        blocks = shard_slices(grouped.shape[1], self.data_axis)
        cells = []
        with torch.inference_mode():
            for (i, j), slot in np.ndenumerate(self.mesh.devices):
                if not self.mesh.is_local(slot) or blocks[j].stop == blocks[j].start:
                    continue
                batch = torch.from_numpy(
                    np.ascontiguousarray(grouped[i, blocks[j]], np.float32)).to(slot.device)
                cells.append((i, blocks[j], frames(
                    self._params[(i, slot.device)], batch, self.config,
                    truncation_psi=self._truncation_psi, compute_dtype=self._compute_dtype,
                    output_side_length=self.output_side_length, phase_top_block_mode=phase_mode)))
        return _GroupedFrames(self, grouped.shape[:2], cells)

    def synthesize_grouped(self, grouped: np.ndarray) -> np.ndarray:
        """
        (n_networks, G, latent) z groups or (n_networks, G, rows, latent) w+
        groups -> (n_networks, G, S, S, 3) uint8 on the host. G must divide
        by the mesh's 'data' axis.
        """
        return self._launch_grouped(grouped).fetch()

    # ---- stream-order surface ----

    def dispatch(
        self,
        frame_data: np.ndarray,
        network_indices: Optional[np.ndarray] = None,
        batch_size: int = 8,
    ) -> Tuple[int, List[Tuple["_GroupedFrames", List[np.ndarray]]]]:
        """
        Route, pad and launch every round for `frame_data` ((N, latent) or
        (N, rows, latent)) with per-frame `network_indices`; returns a handle
        for `gather`. `batch_size` caps the frames per device per round
        (group cap = batch_size x data axis); larger inputs go in rounds of
        one group shape.
        """
        frame_data = np.asarray(frame_data)
        n = frame_data.shape[0]
        if network_indices is None:
            network_indices = np.zeros((n,), dtype=int)
        network_indices = np.asarray(network_indices).astype(int)
        if network_indices.shape != (n,):
            raise ValueError(f"network_indices shape {network_indices.shape} != ({n},)")
        if n and (network_indices.min() < 0 or network_indices.max() >= self.n_networks):
            raise ValueError(
                f"network_indices out of range [0, {self.n_networks}) : "
                f"[{network_indices.min()}, {network_indices.max()}]"
            )
        if n == 0:
            return 0, []
        positions = [np.flatnonzero(network_indices == i) for i in range(self.n_networks)]
        largest = max(len(p) for p in positions)
        cap = max(batch_size, 1) * self.data_axis
        rounds = max(1, math.ceil(largest / cap))
        group = _bucket_size(math.ceil(largest / rounds), batch_size=cap,
                             multiple=self.data_axis)
        dispatched = []
        for round_index in range(rounds):
            chunk_positions = [p[round_index * group: (round_index + 1) * group]
                               for p in positions]
            gather = np.zeros((self.n_networks, group), dtype=int)
            for i, chunk in enumerate(chunk_positions):
                gather[i, : len(chunk)] = chunk  # pad rows re-run frame 0: harmless
            dispatched.append((self._launch_grouped(frame_data[gather]), chunk_positions))
        return n, dispatched

    def gather(self, handle: Tuple[int, List[Tuple["_GroupedFrames", List[np.ndarray]]]]
               ) -> np.ndarray:
        """A `dispatch` handle's frames on the host, in stream order."""
        n, dispatched = handle
        side = self.output_resolution
        out = np.empty((n, side, side, 3), dtype=np.uint8)
        for frames, chunk_positions in dispatched:
            host_images = frames.fetch()
            for i, chunk in enumerate(chunk_positions):
                out[chunk] = host_images[i, : len(chunk)]
        return out

    def synthesize(
        self,
        frame_data: np.ndarray,
        network_indices: Optional[np.ndarray] = None,
        batch_size: int = 8,
    ) -> np.ndarray:
        """`frame_data` with per-frame `network_indices` -> (N, S, S, 3) uint8
        in stream order (one dispatch and gather)."""
        return self.gather(self.dispatch(frame_data, network_indices, batch_size))


class _GroupedFrames:
    """Launched cells of one grouped dispatch; `fetch()` assembles the
    (N, G, S, S, 3) frames on the host, from every process's cells."""

    def __init__(self, owner: NetworkParallelSynthesis, groups: Tuple[int, int],
                 cells: List[Tuple[int, slice, torch.Tensor]]) -> None:
        self.owner = owner
        self.groups = groups
        self.cells = cells

    def fetch(self) -> np.ndarray:
        side = self.owner.output_resolution
        out = np.zeros(tuple(self.groups) + (side, side, 3), np.uint8)
        for i, rows, images in self.cells:
            out[i, rows] = images.cpu().numpy()
        mesh = self.owner.mesh
        if not mesh.grouped:
            return out
        # each process sends the rows of its own cells only, packed in grid
        # order and padded to one size, as JAX fetches each shard from its owner
        blocks = shard_slices(self.groups[1], mesh.shape["data"])
        owned = [[(i, blocks[j]) for (i, j), slot in np.ndenumerate(mesh.devices)
                  if slot.process == p] for p in range(mesh.process_count)]
        sizes = [sum(rows.stop - rows.start for _, rows in cells) for cells in owned]
        packed = np.zeros((max(sizes), side, side, 3), np.uint8)
        mine = [out[i, rows] for i, rows in owned[mesh.process_index]]
        if mine:
            packed[: sizes[mesh.process_index]] = np.concatenate(mine)
        for cells, buffer in zip(owned, all_gather_host(packed)):
            start = 0
            for i, rows in cells:
                out[i, rows] = buffer[start: start + rows.stop - rows.start]
                start += rows.stop - rows.start
        return out
