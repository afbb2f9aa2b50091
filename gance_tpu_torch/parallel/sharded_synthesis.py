"""
Batched synthesis over a mesh's data axis: the counterpart of
gance_tpu/parallel/sharded_synthesis.py.

The params are placed once per data row (`generator_param_sharding`: a copy
on each device with a 'model' axis of 1, a tensor-parallel `GroupParams`
over the row's model slots above 1); a call splits the batch's leading axis
over the data rows (contiguous blocks of ceil(B / data) rows), launches each
of this process's non-empty blocks on its row from the calling thread, and
returns the frames as uint8 on the host, gathered from every process
(`fetch_to_host`). Every process calls with the same full batch, as JAX's
process-spanning meshes require.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gance_tpu_torch.models.frames import frames
from gance_tpu_torch.models.stylegan2 import DEFAULT_TRUNCATION_PSI, GeneratorConfig
from gance_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedRows,
    fetch_to_host,
    generator_param_sharding,
    shard_rows,
)

Params = Dict[str, Any]
ShardFn = Callable[[Params, torch.Tensor], torch.Tensor]


def run_sharded(mesh: Mesh, replicas: Dict[Tuple[torch.device, ...], Any], batch: Any,
                apply: ShardFn, item_shape: tuple, rows: Optional[int] = None) -> ShardedRows:
    """
    Launch `apply(params, rows)` on each of this process's non-empty shards
    of `batch` (numpy or a tensor), each on its data row's lead device with
    that row's params (`generator_param_sharding`); return the launched
    shards as `ShardedRows` (fetch it for the whole batch on the host).
    `rows` keeps only the first rows.
    """
    if not torch.is_tensor(batch):
        batch = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
    parts = []
    with torch.inference_mode():
        for devices, rows_slice in shard_rows(mesh, batch.shape[0]):
            shard = batch[rows_slice].to(devices[0], torch.float32)
            parts.append(apply(replicas[devices], shard))
    return ShardedRows(mesh, batch.shape[0], parts, item_shape, rows)


def make_sharded_synthesis(
    mesh: Mesh,
    params: Params,
    config: GeneratorConfig,
    truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[Any], np.ndarray]:
    """A z-batch (B, latent) -> uint8 (B, R, R, 3) host frames function over
    `mesh` (truncation, constant noise, the fused uint8 epilogue)."""
    replicas = generator_param_sharding(mesh, params)
    res = config.resolution

    def apply(p: Params, z: torch.Tensor) -> torch.Tensor:
        return frames(p, z, config, truncation_psi=truncation_psi, compute_dtype=compute_dtype)

    def synthesize(z: Any) -> np.ndarray:
        return fetch_to_host(run_sharded(mesh, replicas, z, apply, (res, res, 3)))

    return synthesize


def make_sharded_matrix_synthesis(
    mesh: Mesh,
    params: Params,
    config: GeneratorConfig,
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[Any], np.ndarray]:
    """As `make_sharded_synthesis`, for w+ (B, R, 512) inputs."""
    replicas = generator_param_sharding(mesh, params)
    res = config.resolution

    def apply(p: Params, dlatents: torch.Tensor) -> torch.Tensor:
        return frames(p, dlatents, config, truncation_psi=None, compute_dtype=compute_dtype)

    def synthesize(dlatents: Any) -> np.ndarray:
        return fetch_to_host(run_sharded(mesh, replicas, dlatents, apply, (res, res, 3)))

    return synthesize
