"""
Network quality metrics: the counterpart of gance_tpu/metrics.

  * `metrics.ppl`: Perceptual Path Length (the StyleGAN smoothness metric),
    LPIPS distance between synthesized images at epsilon-separated points on
    latent interpolation paths, a chunk of pairs per synthesis batch;
  * `metrics.frechet`: the exact Fréchet distance (the FID formula) over a
    pluggable feature extractor, with streaming float64 moments so any
    sample count passes through constant memory;
  * `metrics.training_eval`: both, on the EMA generator during training.

CLI: `python -m gance_tpu_torch.cli.network_metrics ppl|frechet ...`.
"""

from gance_tpu_torch.metrics.frechet import (
    FeatureMoments,
    frechet_distance_network_vs_images,
    gaussian_frechet_distance,
    pooled_vgg_features,
)
from gance_tpu_torch.metrics.ppl import PPLResult, perceptual_path_length, slerp

__all__ = [
    "FeatureMoments",
    "frechet_distance_network_vs_images",
    "gaussian_frechet_distance",
    "pooled_vgg_features",
    "PPLResult",
    "perceptual_path_length",
    "slerp",
]
