"""
Perceptual Path Length (PPL), the StyleGAN latent-space smoothness metric:
the counterpart of gance_tpu/metrics/ppl.py (NVlabs stylegan2
`metrics/perceptual_path_length.py` semantics).

  * sample latent pairs (z0, z1); pick an interpolation position t, uniform in
    [0, 1) for `sampling="full"`, 0 for `sampling="end"`;
  * interpolate in `space="w"` (lerp between the mapped w0, w1) or `space="z"`
    (slerp between the gaussian latents, then map);
  * synthesize images at t and t + epsilon with constant noise, both endpoints
    stacked into one synthesis batch, optionally center-crop to the face
    region (rows 3c:7c, cols 2c:6c with c = resolution // 8);
  * distance = LPIPS(img_t, img_t+eps) / epsilon^2 at 256px, with the
    pluggable VGG16 metric of projection/lpips.py;
  * reject outliers outside the [1st, 99th] percentile and report the mean.

A chunk of pairs runs on `device` ("cuda" unless the caller asks for the CPU)
under `torch.inference_mode`, through the synthesis kernels. Its draws (z for
both endpoints, then t) come from a CPU `torch.Generator` seeded from (seed,
chunk) and are copied to the device, so the card and the CPU draw the same
numbers (JAX draws from threefry keys; ROADMAP.md lists the departure).
A chunk runs under cuDNN's deterministic algorithms (`deterministic_cudnn`):
the division by epsilon^2 would turn any difference between two calls into a
different PPL for the same seed. Its forwards repeat themselves under cuDNN's
default algorithms too (each `Conv0_up` runs as forward phase convolutions,
ops/upfirdn2d.py), so the guard costs them nothing. Distances are gathered
on the host, one chunk at a time.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from gance_tpu_torch.metrics.frechet import chunk_generator
from gance_tpu_torch.models.stylegan2 import (
    GeneratorConfig,
    broadcast_dlatents,
    mapping_apply,
    synthesis_apply,
    truncate_dlatents,
)
from gance_tpu_torch.ops.precision import deterministic_cudnn
from gance_tpu_torch.projection.lpips import (
    VGGParams,
    downsample_to,
    lpips_distance,
    vgg_params_to_device,
)
from gance_tpu_torch.utils.device import params_to_device, resolve_device

# NVlabs evaluates the perceptual distance at 256px (same as projection).
_PERCEPTUAL_SIZE = 256

# (chunk index, batch) -> (z (2 * batch, latent_size), t (batch, 1)) float32
PairDraws = Callable[[int, int], Tuple[np.ndarray, np.ndarray]]


def slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """
    Spherical interpolation between latent batches (NVlabs `slerp`): inputs are
    unit-normalized, the result is a unit vector at angle fraction `t` along
    the great circle from a to b.

    :param a, b: (B, D); :param t: broadcastable to (B, 1).
    """
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    d = torch.clamp(torch.sum(a * b, dim=-1, keepdim=True), -1.0, 1.0)
    p = t * torch.arccos(d)
    c = b - d * a
    c = c / (torch.linalg.norm(c, dim=-1, keepdim=True) + 1e-12)
    out = a * torch.cos(p) + c * torch.sin(p)
    return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)


def _crop_face_region(images: torch.Tensor) -> torch.Tensor:
    """NVlabs PPL face crop on NHWC images: c = H//8; rows 3c:7c, cols 2c:6c."""
    c = images.shape[1] // 8
    return images[:, c * 3 : c * 7, c * 2 : c * 6, :]


@dataclass
class PPLResult:
    """PPL value + the provenance a JSON report needs."""

    ppl: float
    num_samples: int
    num_filtered: int
    space: str
    sampling: str
    epsilon: float
    crop: bool


def default_pair_draws(seed: int, latent_size: int, sampling: str) -> PairDraws:
    """Chunk i's draws from `chunk_generator(seed, i)`: z ~ N(0, 1) for both
    endpoints, then t ~ U[0, 1) ("full") or t = 0 ("end")."""

    def draw(chunk: int, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        gen = chunk_generator(seed, chunk)
        z = torch.randn((batch * 2, latent_size), generator=gen)
        if sampling == "full":
            t = torch.rand((batch, 1), generator=gen)
        else:
            t = torch.zeros((batch, 1))
        return z.numpy(), t.numpy()

    return draw


def chunk_distances(
    params: Dict[str, Any],
    perceptual: VGGParams,
    z: torch.Tensor,
    t: torch.Tensor,
    config: GeneratorConfig,
    space: str,
    epsilon: float,
    crop: bool,
    truncation_psi: Optional[float],
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """One chunk: z (2B, latent) and t (B, 1) on the params' device -> (B,)
    distances / epsilon^2 (JAX's `_build_chunk_fn` body)."""
    batch = t.shape[0]
    z0, z1 = z[:batch], z[batch:]
    if space == "w":
        w0 = mapping_apply(params, z0, config)
        w1 = mapping_apply(params, z1, config)
        wt0 = w0 + (w1 - w0) * t
        wt1 = w0 + (w1 - w0) * (t + epsilon)
    else:  # "z"
        wt0 = mapping_apply(params, slerp(z0, z1, t), config)
        wt1 = mapping_apply(params, slerp(z0, z1, t + epsilon), config)

    # one synthesis for both endpoints: the pairs stacked into the batch
    dlatents = broadcast_dlatents(torch.cat([wt0, wt1]), config)
    if truncation_psi is not None:
        dlatents = truncate_dlatents(dlatents, params["dlatent_avg"], truncation_psi)
    images = synthesis_apply(params, dlatents, config, noise_mode="const",
                             compute_dtype=compute_dtype).float()
    if crop:
        images = _crop_face_region(images)
    images = downsample_to(images.permute(0, 3, 1, 2).contiguous(), _PERCEPTUAL_SIZE).contiguous()
    d = lpips_distance(perceptual, images[:batch], images[batch:])
    return d * (1.0 / (epsilon**2))


def perceptual_path_length(
    params: Dict[str, Any],
    config: GeneratorConfig,
    perceptual_params: Dict[str, Any],
    num_samples: int = 2048,
    batch_size: int = 8,
    space: str = "w",
    sampling: str = "full",
    epsilon: float = 1e-4,
    crop: bool = False,
    truncation_psi: Optional[float] = None,
    compute_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    pair_draws: Optional[PairDraws] = None,
) -> PPLResult:
    """
    Compute PPL for a generator.

    :param params: generator params (numpy or tensors), copied to `device`.
    :param perceptual_params: projection/lpips.py's numpy VGG dict
        (`load_vgg_params` for real weights, `random_vgg_params` fallback).
    :param truncation_psi: None (NVlabs PPL evaluates the raw mapping output)
        or a psi to measure the truncated sampling distribution instead.
    :param pair_draws: test seam, (chunk index, batch) -> that chunk's (z, t);
        default `default_pair_draws(seed, latent_size, sampling)`.
    :return: PPLResult; `.ppl` is the outlier-filtered mean.
    """
    if space not in ("w", "z"):
        raise ValueError(f"space must be 'w' or 'z', got {space!r}")
    if sampling not in ("full", "end"):
        raise ValueError(f"sampling must be 'full' or 'end', got {sampling!r}")
    device = resolve_device(device)
    draws = pair_draws or default_pair_draws(seed, config.latent_size, sampling)
    params = params_to_device(params, device)
    perceptual = vgg_params_to_device(perceptual_params, device)
    distances = []
    done = 0
    chunk_index = 0
    while done < num_samples:
        batch = min(batch_size, num_samples - done)
        z, t = draws(chunk_index, batch)
        with torch.inference_mode(), deterministic_cudnn():
            d = chunk_distances(
                params, perceptual, torch.tensor(np.asarray(z), dtype=torch.float32).to(device),
                torch.tensor(np.asarray(t), dtype=torch.float32).to(device), config, space,
                float(epsilon), crop, truncation_psi, compute_dtype,
            )
        distances.append(d.cpu().numpy())
        done += batch
        chunk_index += 1
    all_distances = np.concatenate(distances)

    # NVlabs outlier rejection: keep [1st, 99th] percentile, mean the rest.
    lo = np.percentile(all_distances, 1, method="lower")
    hi = np.percentile(all_distances, 99, method="higher")
    filtered = all_distances[(all_distances >= lo) & (all_distances <= hi)]
    return PPLResult(
        ppl=float(np.mean(filtered)),
        num_samples=int(num_samples),
        num_filtered=int(filtered.size),
        space=space,
        sampling=sampling,
        epsilon=float(epsilon),
        crop=bool(crop),
    )
