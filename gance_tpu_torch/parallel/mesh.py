"""
Device meshes for the port: the counterpart of gance_tpu/parallel/mesh.py.

A `Mesh` is a grid of device slots with named axes, ('data', 'model') for
data-parallel work and ('network', 'data') for network-parallel synthesis.
Each slot is a `MeshDevice`: the process that owns it and the torch device
it runs on in that process. Without torch.distributed (or in a group of one)
every slot belongs to this process; in a group of several the grid spans the
processes, process-major, as `jax.devices()` orders a multi-process
runtime's devices, and every process holds the same grid.

The sharding policy is JAX's:
  * batch-leading arrays split their leading axis over 'data' in contiguous
    blocks of ceil(B / data) rows (XLA's layout of an uneven batch), and a
    data row with no rows launches nothing;
  * a param leaf named `weight` with at least `_MIN_SHARDED_PARAM` elements
    is split over 'model' along its output channels (axis 0 of an OIHW conv
    weight, the last axis of a dense (in, out) weight) in contiguous blocks
    of ceil(C / model) channels; every other leaf is replicated
    (`shard_dim`). With a 'model' axis of 1 the params are copied once to
    each device that holds a slot; above 1 each data row's model slots hold
    a `parallel/tensor_parallel.py::GroupParams`, which runs each sharded
    layer column-parallel;
  * frames go to the host as uint8; across processes the host fetch is an
    all_gather, a collective every process reaches in the same order
    (`fetch_to_host`).

The 'model' axis stays inside one process: each data row's model slots must
belong to one process (`create_mesh` raises otherwise). JAX keeps 'model'
inside a slice for the same reason: its collectives run every layer.

An explicit device list may name a device more than once (two slots on one
card, or several on the CPU): the counterpart of the virtual CPU devices the
JAX tests run on.
"""

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gance_tpu_torch.utils.device import params_to_device, resolve_device

Params = Dict[str, Any]

# Weights smaller than this stay replicated: a gather per layer costs more
# than the memory saved (JAX's threshold; read at call time).
_MIN_SHARDED_PARAM = 1 << 16  # 64k elements


class MeshDevice(NamedTuple):
    """One slot of a mesh: the process that owns it and its torch device there."""

    process: int
    device: torch.device


def process_group_info(group: Any = None) -> Tuple[int, int]:
    """(this process's index, the process count) of torch.distributed's
    default group, or (0, 1) when it is not initialized."""
    import torch.distributed as dist

    if in_process_group():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def in_process_group() -> bool:
    """Whether torch.distributed's default group is up (a world of one too:
    its collectives then run through the backend, as they do for many)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def local_devices(device: Union[str, torch.device] = "cuda") -> List[torch.device]:
    """
    The devices this process drives: for "cuda", `initialize_distributed`'s
    local_device_ids when given, else every visible CUDA device (raises on a
    host without CUDA); for "cuda:N" or "cpu", that device.
    """
    device = resolve_device(device)
    if device.type == "cpu" or device.index is not None:
        return [device]
    from gance_tpu_torch.parallel.distributed import configured_local_device_ids

    ids = configured_local_device_ids()
    if ids is None:
        ids = range(torch.cuda.device_count())
    return [torch.device("cuda", int(i)) for i in ids]


def _indexed(device: Union[str, torch.device]) -> torch.device:
    """A CUDA device with its index (the current device's when unnamed), as
    tensors report theirs."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def global_devices(
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Union[str, torch.device] = "cuda",
) -> List[MeshDevice]:
    """Every slot of the process group, process-major: this process's
    `devices` (default `local_devices(device)`) repeated for each process, so
    every process must drive as many devices, in the same order."""
    local = [_indexed(d) for d in devices] if devices is not None else local_devices(device)
    if not local:
        raise ValueError("no devices to build a mesh over")
    _, count = process_group_info()
    return [MeshDevice(p, d) for p in range(count) for d in local]


class Mesh:
    """A grid of `MeshDevice` slots with named axes (JAX's `Mesh`)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"grid of rank {devices.ndim} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index, self.process_count = process_group_info()
        # host fetches and reductions go through the group's collectives
        self.grouped = in_process_group()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, slot: MeshDevice) -> bool:
        return slot.process == self.process_index

    @property
    def local_devices(self) -> List[torch.device]:
        """The distinct devices of this process's slots, in grid order."""
        return list(dict.fromkeys(s.device for s in self.devices.flat if self.is_local(s)))

    @property
    def first_device(self) -> torch.device:
        return self.local_devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, processes={self.process_count})"


def _hybrid_device_grid(devices: list, data_parallel: int, model_parallel: int) -> np.ndarray:
    """
    Arrange multi-slice devices into a (data, model) grid: the 'model' axis
    lives within one slice and the 'data' axis varies the slice index
    slowest. A pure function over any objects with a `slice_index`
    attribute (a copy of gance_tpu's; torch devices have none, so a port
    mesh is one slice).
    """
    slices: dict = {}
    for device in devices:
        slices.setdefault(getattr(device, "slice_index", 0), []).append(device)
    per_slice = {k: len(v) for k, v in slices.items()}
    if len(set(per_slice.values())) != 1:
        raise ValueError(f"Uneven devices per slice: {per_slice}")
    slice_size = next(iter(per_slice.values()))
    if slice_size % model_parallel:
        raise ValueError(
            f"model axis {model_parallel} must divide the slice size {slice_size} "
            "(tensor-parallel collectives must stay on ICI)"
        )
    dp_per_slice = slice_size // model_parallel
    if data_parallel != dp_per_slice * len(slices):
        raise ValueError(
            f"dp={data_parallel} != per-slice dp {dp_per_slice} x {len(slices)} slices"
        )
    rows = []
    for slice_index in sorted(slices):
        rows.append(
            np.asarray(slices[slice_index], dtype=object).reshape(dp_per_slice, model_parallel)
        )
    return np.concatenate(rows, axis=0)


def _object_grid(items: Sequence[Any], shape: Tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        grid[i] = item
    return grid.reshape(shape)


def create_mesh(
    n_devices: Optional[int] = None,
    data_parallel: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Mesh:
    """
    A ('data', 'model') mesh over every process's devices (JAX's
    `create_mesh`): pure data parallelism by default. `devices` is this
    process's device list (default `local_devices(device)`: every visible
    CUDA device once); it may repeat a device. `n_devices` keeps the first
    that many slots of the global list. A `data_parallel` below the slot
    count leaves a tensor-parallel 'model' axis of count / data_parallel
    slots, which must lie in one process for every data row (ValueError
    otherwise).
    """
    slots = global_devices(devices, device)
    if n_devices is not None:
        slots = slots[:n_devices]
    count = len(slots)
    if data_parallel is None:
        data_parallel, model_parallel = count, 1
    else:
        if count % data_parallel:
            raise ValueError(f"{count} devices not divisible by dp={data_parallel}")
        model_parallel = count // data_parallel
    grid = _object_grid(slots, (data_parallel, model_parallel))
    for row in grid:
        if len({slot.process for slot in row}) > 1:
            raise ValueError(
                f"a 'model' axis of {model_parallel} would span processes "
                f"{sorted({slot.process for slot in row})}: it stays inside one process "
                f"(its gathers run every layer), so each process's slot count must be a "
                f"multiple of it")
    return Mesh(grid, ("data", "model"))


def model_axis_size(mesh: Optional[Mesh]) -> int:
    return int(mesh.shape.get("model", 1)) if mesh is not None else 1


def data_axis_size(mesh: Optional[Mesh]) -> int:
    return int(mesh.shape.get("data", 1)) if mesh is not None else 1


def _bucket_size(real: int, batch_size: int, multiple: int = 1) -> int:
    """Smallest `multiple`·2^k >= `real`, capped at `batch_size`: bounds pad
    waste on partial batches at under 2x. The serving batcher buckets with
    `multiple` 8; the stream and network-parallel synthesis with the data axis."""
    size = multiple
    while size < real and size < batch_size:
        size *= 2
    return min(size, batch_size)


def shard_slices(n: int, parts: int) -> List[slice]:
    """Contiguous blocks of ceil(n / parts) rows, one per part (the last
    ones may be short or empty), as XLA lays out an uneven batch."""
    per = -(-n // parts) if n else 0
    return [slice(min(i * per, n), min((i + 1) * per, n)) for i in range(parts)]


class Shard(NamedTuple):
    """The rows of a batch that one data slot of this process computes."""

    device: torch.device
    rows: slice


def _data_slots(mesh: Mesh, n: int) -> List[Tuple[MeshDevice, slice]]:
    """Each data row's lead slot (its first model slot) with its rows of an
    n-row batch."""
    slots = mesh.devices.reshape(data_axis_size(mesh), -1)[:, 0]
    return list(zip(slots, shard_slices(n, len(slots))))


def row_devices(mesh: Mesh, row: int) -> Tuple[torch.device, ...]:
    """The devices of data row `row`'s model slots, lead first."""
    return tuple(slot.device for slot in mesh.devices.reshape(data_axis_size(mesh), -1)[row])


def local_row_groups(mesh: Mesh) -> List[Tuple[torch.device, ...]]:
    """The distinct model groups (device tuples, lead first) of this
    process's data rows, in row order."""
    rows = mesh.devices.reshape(data_axis_size(mesh), -1)
    return list(dict.fromkeys(row_devices(mesh, r) for r in range(rows.shape[0])
                              if mesh.is_local(rows[r, 0])))


class RowShard(NamedTuple):
    """The rows of a batch that one data row of this process computes, and
    the devices of its model slots (lead first)."""

    devices: Tuple[torch.device, ...]
    rows: slice


def shard_rows(mesh: Mesh, n: int) -> List[RowShard]:
    """This process's non-empty shards of an n-row batch over the mesh's data
    axis, in row order (the counterpart of JAX's `shard_batch` sharding),
    each with its data row's model group."""
    rows = mesh.devices.reshape(data_axis_size(mesh), -1)
    return [RowShard(row_devices(mesh, r), piece)
            for r, piece in enumerate(shard_slices(n, rows.shape[0]))
            if mesh.is_local(rows[r, 0]) and piece.stop > piece.start]


def shard_batch(mesh: Mesh, n: int) -> List[Shard]:
    """`shard_rows` with each shard on its data row's lead device."""
    return [Shard(shard.devices[0], shard.rows) for shard in shard_rows(mesh, n)]


def process_rows(mesh: Mesh, n: int, process: Optional[int] = None) -> slice:
    """The rows of an n-row batch that `process`'s data slots hold."""
    process = mesh.process_index if process is None else process
    mine = [rows for slot, rows in _data_slots(mesh, n) if slot.process == process]
    if not mine:
        return slice(0, 0)
    return slice(mine[0].start, mine[-1].stop)


def replicated(mesh: Mesh, params: Params) -> Dict[torch.device, Params]:
    """`params` (numpy or tensors) copied once to each of this process's devices."""
    return {device: params_to_device(params, device) for device in mesh.local_devices}


def shard_dim(path: Tuple[str, ...], shape: Sequence[int]) -> Optional[int]:
    """
    The axis a param leaf splits over 'model', or None where it is
    replicated (JAX's `_leaf_spec`): a leaf named `weight` with at least
    `_MIN_SHARDED_PARAM` elements splits its output channels, axis 0 of an
    OIHW conv weight and the last axis of a dense (in, out) weight (JAX's
    last axis in both, its conv weights being HWIO). `mod_weight`, biases,
    consts, noise buffers and scalars stay whole.
    """
    size = int(np.prod(shape)) if len(shape) else 1
    if size < _MIN_SHARDED_PARAM or not path or path[-1] != "weight":
        return None
    return 0 if len(shape) == 4 else len(shape) - 1


def param_spec(params: Params, path: Tuple[str, ...] = ()) -> Params:
    """The tree of `shard_dim` of every leaf of `params`."""
    if isinstance(params, dict):
        return {key: param_spec(value, path + (key,)) for key, value in params.items()}
    return shard_dim(path, tuple(np.shape(params)))


def _param_sharding(mesh: Mesh, params: Params) -> Dict[Tuple[torch.device, ...], Any]:
    if model_axis_size(mesh) == 1:
        return {(device,): tree for device, tree in replicated(mesh, params).items()}
    from gance_tpu_torch.parallel.tensor_parallel import GroupParams

    return {devices: GroupParams.place(params, devices) for devices in local_row_groups(mesh)}


def generator_param_sharding(mesh: Mesh, params: Params) -> Dict[Tuple[torch.device, ...], Any]:
    """
    Generator params on the mesh, per distinct model group of this process's
    data rows (keyed by its devices, lead first): with a 'model' axis of 1 a
    copy on each device, above 1 a `GroupParams` whose slots hold the
    sharded leaves' blocks (`shard_dim`) and the replicated leaves whole.
    """
    return _param_sharding(mesh, params)


def discriminator_param_sharding(mesh: Mesh, params: Params) -> Dict[Tuple[torch.device, ...], Any]:
    """Discriminator params on the mesh, as `generator_param_sharding`."""
    return _param_sharding(mesh, params)


def gather_params(params: Any) -> Params:
    """A params tree of whole leaves as numpy arrays on the host: the sharded
    leaves of a `GroupParams` concatenated back (for checkpoints and tests),
    a tree of tensors copied."""
    if isinstance(params, dict):
        return {key: gather_params(value) for key, value in params.items()}
    if torch.is_tensor(params):
        return params.detach().cpu().numpy().copy()
    if hasattr(params, "gather"):
        return params.gather()
    return np.asarray(params)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _uses_nccl() -> bool:
    import torch.distributed as dist

    return dist.get_backend() == "nccl"


def all_gather_host(value: np.ndarray) -> List[np.ndarray]:
    """
    Every process's `value` (the same shape and dtype on all), in process
    order: a collective. Under NCCL it travels through this process's
    current CUDA device; under gloo it is gathered from host memory (the
    gloo branch stages CUDA data on the host, where frames go anyway).
    """
    import torch.distributed as dist

    if not in_process_group():
        return [value]
    _, count = process_group_info()
    tensor = torch.from_numpy(np.ascontiguousarray(value))
    if _uses_nccl():
        tensor = tensor.to(torch.device("cuda", torch.cuda.current_device()))
    gathered = [torch.empty_like(tensor) for _ in range(count)]
    dist.all_gather(gathered, tensor)
    return [g.cpu().numpy() for g in gathered]


def _collective_(tensor: torch.Tensor, run: Any) -> torch.Tensor:
    """Run the in-place collective `run` on `tensor` where the backend
    communicates: under NCCL on this process's current device (a tensor on
    another of its GPUs, such as a model slot's block, is staged there, so
    each process keeps one communicator); under gloo in host memory."""
    if tensor.device.type == "cpu":
        run(tensor)
        return tensor
    if _uses_nccl():
        current = torch.device("cuda", torch.cuda.current_device())
        if tensor.device == current:
            run(tensor)
            return tensor
        staged = tensor.to(current)
    else:
        staged = tensor.cpu()
    run(staged)
    return tensor.copy_(staged)


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the process group, in place (a collective; a no-op
    in a process alone)."""
    import torch.distributed as dist

    if not in_process_group():
        return tensor
    return _collective_(tensor, dist.all_reduce)


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process `src`'s `tensor` to every process, in place (a collective)."""
    import torch.distributed as dist

    if not in_process_group():
        return tensor
    return _collective_(tensor, lambda t: dist.broadcast(t, src))


def gather_rows(mesh: Mesh, local: np.ndarray, n: int) -> np.ndarray:
    """
    The n rows of a batch sharded over the data axis, on every process,
    from this process's rows `local` (rows `process_rows(mesh, n)`): an
    all_gather across the process group (padded to one size), a no-op
    without one.
    """
    if not mesh.grouped:
        return local
    width = max(r.stop - r.start for r in (process_rows(mesh, n, p)
                                            for p in range(mesh.process_count)))
    padded = np.zeros((width,) + local.shape[1:], local.dtype)
    padded[: local.shape[0]] = local
    parts = all_gather_host(padded)
    return np.concatenate([
        part[: process_rows(mesh, n, p).stop - process_rows(mesh, n, p).start]
        for p, part in enumerate(parts)
    ])


def fetch_to_host(value: Any) -> np.ndarray:
    """
    Device data -> host numpy (JAX's `fetch_to_host`). `ShardedRows` (a
    batch computed over a mesh) are copied from each device and, across
    processes, all-gathered: a collective that every process must reach in
    the same order. Tensors are copied; anything else goes through
    np.asarray.
    """
    if isinstance(value, ShardedRows):
        return value.fetch()
    if torch.is_tensor(value):
        return value.cpu().numpy()
    return np.asarray(value)


class ShardedRows:
    """
    An n-row batch computed over a mesh's data axis: this process's shards
    as tensors on their devices (launched, not synced). `fetch()` returns the
    whole batch on the host, gathering the other processes' rows.
    """

    def __init__(self, mesh: Mesh, n: int, parts: Sequence[torch.Tensor],
                 item_shape: Tuple[int, ...], rows: Optional[int] = None) -> None:
        self.mesh = mesh
        self.n = n
        self.parts = list(parts)
        self.item_shape = tuple(item_shape)
        self.rows = n if rows is None else rows  # rows kept by fetch (pads sliced off)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.rows,) + self.item_shape

    def fetch(self) -> np.ndarray:
        local = np.zeros((0,) + self.item_shape, np.uint8)
        if self.parts:
            local = np.concatenate([p.cpu().numpy() for p in self.parts])
        return gather_rows(self.mesh, local, self.n)[: self.rows]
