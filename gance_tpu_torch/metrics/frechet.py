"""
Fréchet feature distance, the FID formula over a pluggable feature extractor:
the counterpart of gance_tpu/metrics/frechet.py.

The math is the exact Fréchet (2-Wasserstein) distance between gaussians fit
to feature distributions:

    d^2 = |mu_a - mu_b|^2 + tr(cov_a + cov_b - 2 (cov_a cov_b)^{1/2})

in numpy float64 (`FeatureMoments` and `gaussian_frechet_distance` are the
JAX package's, copied). The default features are the VGG16 stack projection
uses (projection/lpips.py: the NVlabs vgg16_zhang_perceptual.pkl, or the
deterministic random-VGG fallback), global-average-pooled per block and
concatenated, so distances compare only within one feature configuration and
are NOT published-FID numbers; an Inception-v3 extractor goes into the
`feature_fn` slot.

The generated side synthesizes on `device` ("cuda" unless the caller asks for
the CPU) under `torch.inference_mode`. Its latents are drawn from a CPU
`torch.Generator` seeded from (seed, chunk) and copied to the device, so the
card and the CPU draw the same numbers (JAX draws them from threefry keys,
which torch cannot reproduce; ROADMAP.md lists the departure). Both sides
run under cuDNN's deterministic algorithms (`deterministic_cudnn`), so that a
seed gives the same distance on every call (see metrics/ppl.py). Features
stream through a float64 (sum, outer-product sum) accumulator, so memory is
constant in the sample count.
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from gance_tpu_torch.models.stylegan2 import GeneratorConfig, generator_apply, images_to_uint8
from gance_tpu_torch.ops.precision import deterministic_cudnn
from gance_tpu_torch.projection.lpips import (
    DEFAULT_FEATURE_BLOCKS,
    VGGParams,
    downsample_to,
    vgg_features,
    vgg_params_to_device,
)
from gance_tpu_torch.utils.device import params_to_device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER

_FEATURE_SIZE = 256  # evaluate features at 256px, like projection and PPL

FeatureFn = Callable[[Any, torch.Tensor], torch.Tensor]
# (chunk index, batch) -> z (batch, latent_size) float32: a chunk's draws
LatentDraws = Callable[[int, int], np.ndarray]


def chunk_generator(seed: int, chunk: int) -> torch.Generator:
    """The CPU generator of one chunk's draws, seeded from (seed, chunk)
    through numpy's SeedSequence (the CPU generator keeps 32 bits of a seed)."""
    state = np.random.SeedSequence([seed % 2**32, chunk]).generate_state(1)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


def pooled_vgg_features(
    params: VGGParams,
    images: torch.Tensor,
    feature_blocks: Sequence[int] = DEFAULT_FEATURE_BLOCKS,
) -> torch.Tensor:
    """
    (B, H, W, 3) float images in [-1, 1], NHWC as synthesis returns them ->
    (B, D) pooled VGG features: each selected block's activations averaged
    over space, concatenated along channels (blocks 0-4 -> D = 64 + 128 + 256
    + 512 + 512 = 1472). Runs NCHW after one transpose at the entry.
    :param params: from `projection/lpips.py::vgg_params_to_device`.
    """
    x = images.float().permute(0, 3, 1, 2).contiguous()
    x = downsample_to(x, _FEATURE_SIZE).contiguous()
    feats = vgg_features(params, x, feature_blocks)
    return torch.cat([f.mean(dim=(2, 3)) for f in feats], dim=1)


@dataclass
class FeatureMoments:
    """Streaming mean/covariance accumulator (float64, constant memory)."""

    dim: int
    count: int = 0
    _sum: np.ndarray = field(init=False)
    _outer: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self._sum = np.zeros((self.dim,), np.float64)
        self._outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, features: np.ndarray) -> None:
        features = np.asarray(features, np.float64)
        if features.ndim != 2 or features.shape[1] != self.dim:
            raise ValueError(f"expected (B, {self.dim}), got {features.shape}")
        self._sum += features.sum(axis=0)
        self._outer += features.T @ features
        self.count += features.shape[0]

    def finalize(self) -> tuple:
        """(mu, cov) with the sample (ddof=1) covariance, matching np.cov."""
        if self.count < 2:
            raise ValueError("need at least 2 samples for a covariance")
        mu = self._sum / self.count
        cov = (self._outer - self.count * np.outer(mu, mu)) / (self.count - 1)
        return mu, cov


def gaussian_frechet_distance(
    mu_a: np.ndarray, cov_a: np.ndarray, mu_b: np.ndarray, cov_b: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """
    Exact Fréchet distance between two gaussians (the FID formula). The matrix
    square root uses scipy.linalg.sqrtm on the product; a tiny eps*I ridge is
    added on numerical failure (the standard FID implementations' guard).
    """
    from scipy import linalg

    mu_a = np.atleast_1d(np.asarray(mu_a, np.float64))
    mu_b = np.atleast_1d(np.asarray(mu_b, np.float64))
    cov_a = np.atleast_2d(np.asarray(cov_a, np.float64))
    cov_b = np.atleast_2d(np.asarray(cov_b, np.float64))

    diff = mu_a - mu_b
    covmean = linalg.sqrtm(cov_a.dot(cov_b))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov_a.shape[0]) * eps
        covmean = linalg.sqrtm((cov_a + offset).dot(cov_b + offset))
    if np.iscomplexobj(covmean):
        # sqrtm of a PSD-matrix product is real up to round-off; a large
        # imaginary part means the covariances were not meaningful (typically
        # rank-deficient: fewer samples than feature dims). Warn, so that a
        # training curve survives, and flag the number as unreliable.
        imag_max = float(np.abs(np.diagonal(covmean).imag).max())
        if imag_max > 1e-3:
            LOGGER.warning(
                "Frechet sqrtm is significantly complex (max diagonal imag "
                "%.3g) — covariances are likely rank-deficient (sample count "
                "below the feature dim); treat this distance as unreliable.",
                imag_max,
            )
        covmean = covmean.real
    value = diff.dot(diff) + np.trace(cov_a) + np.trace(cov_b) - 2.0 * np.trace(covmean)
    # Exact-zero case (identical inputs) can land epsilon-negative.
    return float(max(value, 0.0))


def default_latent_draws(seed: int, latent_size: int) -> LatentDraws:
    """Chunk i's z: N(0, 1) from `chunk_generator(seed, i)`."""

    def draw(chunk: int, batch: int) -> np.ndarray:
        return torch.randn((batch, latent_size), generator=chunk_generator(seed, chunk)).numpy()

    return draw


def _network_feature_stream(
    params: Dict[str, Any],
    config: GeneratorConfig,
    extractor: Any,
    num_samples: int,
    batch_size: int,
    truncation_psi: Optional[float],
    feature_fn: FeatureFn,
    draws: LatentDraws,
    device: torch.device,
) -> Iterator[np.ndarray]:
    """Pooled features of freshly sampled network outputs, one batch at a time."""
    done = 0
    index = 0
    while done < num_samples:
        batch = min(batch_size, num_samples - done)
        z = torch.tensor(np.asarray(draws(index, batch)), dtype=torch.float32).to(device)
        with torch.inference_mode(), deterministic_cudnn():
            images = generator_apply(params, z, config, truncation_psi=truncation_psi,
                                     noise_mode="const")
            # the DELIVERED distribution: quantised as the uint8 images a user
            # saves or serves (and as the real side reads back)
            images = images_to_uint8(images).float() / 127.5 - 1.0
            features = feature_fn(extractor, images)
        yield features.float().cpu().numpy()
        done += batch
        index += 1


def _image_feature_stream(
    image_paths: Sequence[Path],
    resolution: int,
    extractor: Any,
    batch_size: int,
    feature_fn: FeatureFn,
    device: torch.device,
) -> Iterator[np.ndarray]:
    """Pooled features of on-disk images (resized to `resolution` with cv2's
    INTER_AREA, [-1, 1])."""
    import cv2

    from gance_tpu_torch.media.images import read_image

    for start in range(0, len(image_paths), batch_size):
        chunk_paths = image_paths[start : start + batch_size]
        images = np.stack(
            [
                cv2.resize(
                    read_image(p), (resolution, resolution), interpolation=cv2.INTER_AREA,
                ).astype(np.float32)
                / 127.5
                - 1.0
                for p in chunk_paths
            ]
        )
        with torch.inference_mode(), deterministic_cudnn():
            features = feature_fn(extractor, torch.from_numpy(images).to(device))
        yield features.float().cpu().numpy()


def frechet_distance_network_vs_images(
    params: Dict[str, Any],
    config: GeneratorConfig,
    perceptual_params: Dict[str, Any],
    image_directory: Path,
    num_samples: int = 2048,
    batch_size: int = 8,
    truncation_psi: Optional[float] = None,
    feature_fn: Optional[FeatureFn] = None,
    seed: int = 0,
    feature_stream_hook: Optional[
        Callable[[str, Iterator[np.ndarray]], Iterator[np.ndarray]]] = None,
    device: Union[str, torch.device] = "cuda",
    latent_draws: Optional[LatentDraws] = None,
) -> Dict[str, Any]:
    """
    Fréchet feature distance between a generator's sampling distribution and an
    image folder (the training-set quality check FID performs, over the
    pluggable features).

    :param params: generator params (numpy or tensors), copied to `device`.
    :param perceptual_params: with the default features, the numpy VGG dict of
        `projection/lpips.py` (`load_vgg_params`, `random_vgg_params`); with
        a `feature_fn`, whatever that function takes, passed as given.
    :param num_samples: generated-sample count; the real side uses every image
        in the folder (capped at num_samples, taking the sorted prefix).
        Counts at or below the feature dim (1472 for the default extractor)
        give rank-deficient covariances: fine for a relative training curve,
        logged as unreliable for absolute comparison.
    :param truncation_psi: None/1.0 = untruncated sampling, the FID convention.
    :param feature_fn: (extractor params, (B, H, W, 3) float images in
        [-1, 1] on `device`) -> (B, D) features; default `pooled_vgg_features`.
    :param feature_stream_hook: test seam, wraps each ("fake"|"real", stream).
    :param latent_draws: test seam, (chunk index, batch) -> that chunk's z;
        default `default_latent_draws(seed, latent_size)`.
    :return: dict with `distance`, the per-side sample counts, and provenance.
    """
    from gance_tpu_torch.parallel.data import list_image_paths

    device = resolve_device(device)
    if feature_fn is None:
        feature_fn = pooled_vgg_features
        extractor = vgg_params_to_device(perceptual_params, device)
    else:
        extractor = perceptual_params
    draws = latent_draws or default_latent_draws(seed, config.latent_size)

    paths = list_image_paths(Path(image_directory))
    if len(paths) < 2:
        raise ValueError(f"Need at least 2 images in {image_directory}")
    paths = paths[: num_samples or len(paths)]

    fake_stream: Iterator[np.ndarray] = _network_feature_stream(
        params_to_device(params, device), config, extractor, num_samples, batch_size,
        truncation_psi, feature_fn, draws, device,
    )
    real_stream: Iterator[np.ndarray] = _image_feature_stream(
        paths, config.resolution, extractor, batch_size, feature_fn, device
    )
    if feature_stream_hook is not None:
        fake_stream = feature_stream_hook("fake", fake_stream)
        real_stream = feature_stream_hook("real", real_stream)

    moments = {}
    for name, stream in (("fake", fake_stream), ("real", real_stream)):
        accumulator = None
        for features in stream:
            if accumulator is None:
                accumulator = FeatureMoments(dim=features.shape[1])
            accumulator.update(features)
        moments[name] = accumulator

    mu_fake, cov_fake = moments["fake"].finalize()
    mu_real, cov_real = moments["real"].finalize()
    min_count = min(moments["fake"].count, moments["real"].count)
    if min_count <= mu_fake.shape[0]:
        LOGGER.warning(
            "Frechet covariances are rank-deficient (%d samples over %d "
            "feature dims) — comparable across steps of one run, unreliable "
            "as an absolute distance.",
            min_count,
            int(mu_fake.shape[0]),
        )
    return {
        "distance": gaussian_frechet_distance(mu_fake, cov_fake, mu_real, cov_real),
        "num_fake": moments["fake"].count,
        "num_real": moments["real"].count,
        "feature_dim": int(mu_fake.shape[0]),
        "note": (
            "Frechet distance over pooled VGG16 features (pluggable; NOT "
            "comparable to published Inception-FID numbers)"
            if feature_fn is pooled_vgg_features
            else "Frechet distance over custom feature_fn features"
        ),
    }
