"""
Multi-process runtime: the counterpart of gance_tpu/parallel/distributed.py
on torch.distributed.

  * `initialize_distributed` joins this process into a group over a
    `tcp://` rendezvous at the coordinator's host:port. The backend is
    chosen from each rank's (host, devices), exchanged through the
    rendezvous store first: NCCL when every rank drives CUDA devices that no
    other rank drives, gloo on the CPU and where ranks share a GPU (NCCL
    refuses two ranks on one device). The choice is logged.
  * `global_batch` / `global_scan_block` hand a process's rows of a global
    batch to the trainer: each process loads only its shard
    (`parallel/data.py` shards the file list by process index).
  * `is_coordinator` picks the process that owns files and logs.

After it, `create_mesh()` builds one mesh over every process's devices,
process-major, as JAX's `jax.devices()` orders them.
"""

import json
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gance_tpu_torch.utils.logging import LOGGER

_STATE: dict = {}
# how long a rank waits for the others at the rendezvous and in a collective
RENDEZVOUS_TIMEOUT_S = 600.0


def configured_local_device_ids() -> Optional[List[int]]:
    """The local_device_ids this process was initialized with, or None."""
    return _STATE.get("local_device_ids")


def _placement(device: Union[str, torch.device],
               local_device_ids: Optional[Sequence[int]]) -> Tuple[str, List[str]]:
    """(host name, this rank's device identities): CUDA devices by UUID where
    torch reports one, else by index; nothing for the CPU."""
    host = socket.gethostname()
    if torch.device(device).type != "cuda":
        return host, []
    ids = list(local_device_ids) if local_device_ids is not None else list(
        range(torch.cuda.device_count()))
    idents = []
    for i in ids:
        uuid = getattr(torch.cuda.get_device_properties(int(i)), "uuid", None)
        idents.append(str(uuid) if uuid is not None else f"{host}/cuda:{int(i)}")
    return host, idents


def choose_backend(placements: Sequence[Tuple[str, Sequence[str]]]) -> str:
    """NCCL when every rank drives CUDA devices and no device is driven by
    two ranks; gloo otherwise (the CPU, or ranks sharing a GPU)."""
    seen: List[str] = []
    for _, idents in placements:
        if not idents:
            return "gloo"
        seen.extend(idents)
    return "nccl" if len(seen) == len(set(seen)) else "gloo"


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
    device: Union[str, torch.device] = "cuda",
) -> str:
    """
    Join this process into a torch.distributed group of `num_processes`
    (JAX's `initialize_distributed`). Run it before building any mesh or
    loading any network. `coordinator_address` is process 0's host:port;
    `local_device_ids` are the CUDA devices this process drives (default:
    every visible one); `device` "cpu" joins with the CPU's backend.

    Idempotent for the same (coordinator, num_processes, process_id) triple;
    a conflicting re-init raises. A rank that cannot join raises.
    :return: the backend chosen ("nccl" or "gloo").
    """
    import torch.distributed as dist

    wanted = (coordinator_address, int(num_processes), int(process_id))
    state = _STATE.get("triple")
    if state is not None:
        if state == wanted:
            return _STATE["backend"]
        raise RuntimeError(
            f"torch.distributed already initialized as {state}; cannot re-init as {wanted}"
        )
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--dist-coordinator must be host:port, got {coordinator_address!r}")
    timeout = timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), int(num_processes), is_master=int(process_id) == 0,
                          timeout=timeout)
    mine = _placement(device, local_device_ids)
    store.set(f"gance_tpu_torch/placement/{process_id}", json.dumps(mine))
    placements = [tuple(json.loads(store.get(f"gance_tpu_torch/placement/{rank}")))
                  for rank in range(int(num_processes))]
    backend = choose_backend(placements)
    if backend == "nccl":
        first = local_device_ids[0] if local_device_ids else 0
        torch.cuda.set_device(int(first))
    dist.init_process_group(backend, store=store, rank=int(process_id),
                            world_size=int(num_processes), timeout=timeout)
    _STATE.update(triple=wanted, backend=backend,
                  local_device_ids=list(local_device_ids) if local_device_ids is not None
                  else None)
    LOGGER.info(
        "torch.distributed up: process %d/%d over %s (%s; ranks' placements %s)",
        process_id, num_processes, backend,
        "each rank drives its own GPUs" if backend == "nccl"
        else "CPU ranks or ranks sharing a GPU", placements,
    )
    return backend


@dataclass
class GlobalRows:
    """A process's rows of a global batch: rows [offset, offset + len(local))
    of a batch of `total` rows along `axis` (0 for a batch, 1 for a scanned
    block of batches)."""

    local: np.ndarray
    offset: int
    total: int
    axis: int = 0

    def rows(self, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop) of the global batch, which must be this process's."""
        have = self.local.shape[self.axis]
        if start < self.offset or stop > self.offset + have:
            raise ValueError(
                f"rows [{start}, {stop}) of the global batch are not this process's "
                f"[{self.offset}, {self.offset + have})"
            )
        index = [slice(None)] * self.local.ndim
        index[self.axis] = slice(start - self.offset, stop - self.offset)
        return self.local[tuple(index)]

    def step(self, s: int) -> "GlobalRows":
        """Step s of a scanned block, as a batch."""
        return GlobalRows(self.local[s], self.offset, self.total, 0)

    def __len__(self) -> int:
        return self.local.shape[0]


def _process_block(mesh, local: np.ndarray, axis: int) -> Union[np.ndarray, GlobalRows]:
    from gance_tpu_torch.parallel.mesh import process_rows

    if mesh.process_count == 1:
        return local
    per = local.shape[axis]
    total = per * mesh.process_count
    mine = process_rows(mesh, total)
    if (mine.start, mine.stop) != (mesh.process_index * per, (mesh.process_index + 1) * per):
        raise ValueError(
            f"a local batch of {per} rows per process does not fill this process's data "
            f"slots evenly ({mesh.shape['data']} slots over {mesh.process_count} processes)"
        )
    return GlobalRows(local, mine.start, total, axis)


def global_batch(mesh, local_batch) -> Union[np.ndarray, GlobalRows]:
    """
    A process's local batch as its rows of the global (B_local x processes)
    batch over the mesh's data axis. With one process the host data is
    returned unchanged, so call sites need no single- or multi-process
    branch.
    """
    return _process_block(mesh, np.asarray(local_batch), 0)


def global_scan_block(mesh, local_block) -> Union[np.ndarray, GlobalRows]:
    """`global_batch` for a scanned block (S, B_local, ...): the step axis
    stays whole."""
    return _process_block(mesh, np.asarray(local_block), 1)


def is_coordinator() -> bool:
    """True on the process that owns singleton host-side work (files, logs)."""
    from gance_tpu_torch.parallel.mesh import process_group_info

    return process_group_info()[0] == 0
