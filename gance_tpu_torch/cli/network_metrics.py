"""
CLI: network quality metrics (PPL, Fréchet feature distance) with the port:
the counterpart of gance_tpu/cli/network_metrics.py, with the same commands,
options and JSON keys plus `--device` (`cuda` by default, `cpu` to run on the
CPU). Each command prints ONE JSON line.

    python -m gance_tpu_torch.cli.network_metrics ppl --network net.pkl
    python -m gance_tpu_torch.cli.network_metrics frechet --network net.pkl \
        --dataset-directory images
"""

import json
from pathlib import Path
from typing import Optional

import click

from gance_tpu_torch.utils.logging import LOGGER, add_log_file

_DEVICE_OPTION = click.option("--device", type=str, default="cuda", show_default=True,
                              help="Torch device to evaluate on ('cuda' or 'cpu').")


def _perceptual_params(vgg_weights: Optional[str]):
    from gance_tpu_torch.projection.lpips import load_vgg_params, random_vgg_params

    if vgg_weights:
        return load_vgg_params(Path(vgg_weights))
    LOGGER.info("No --vgg-weights given: using the deterministic random-VGG metric.")
    return random_vgg_params(seed=0)


@click.group()
def cli() -> None:
    """Evaluate trained networks: latent-space smoothness (ppl), distribution
    distance to a dataset (frechet)."""


@cli.command()
@click.option("--network", type=click.Path(exists=True, dir_okay=False), required=True)
@click.option("--num-samples", type=click.IntRange(min=2), default=2048)
@click.option("--batch-size", type=click.IntRange(min=1), default=8)
@click.option("--space", type=click.Choice(["w", "z"]), default="w")
@click.option("--sampling", type=click.Choice(["full", "end"]), default="full")
@click.option("--epsilon", type=float, default=1e-4)
@click.option(
    "--crop/--no-crop", default=False,
    help="Center-crop the NVlabs face region (use for 1024px face models).",
)
@click.option(
    "--truncation-psi", type=float, default=None,
    help="Measure the truncated distribution; default: raw mapping output "
    "(the NVlabs PPL configuration).",
)
@click.option(
    "--compute-dtype", type=click.Choice(["float32", "bfloat16"]), default="float32",
)
@click.option(
    "--vgg-weights", type=click.Path(exists=True, dir_okay=False), default=None,
    help="NVlabs vgg16_zhang_perceptual.pkl or imported .npz; default: "
    "deterministic random-VGG (values comparable only within one metric).",
)
@click.option("--seed", type=int, default=0)
@_DEVICE_OPTION
@click.option("--log", type=click.Path(dir_okay=False), default=None)
def ppl(
    network: str,
    num_samples: int,
    batch_size: int,
    space: str,
    sampling: str,
    epsilon: float,
    crop: bool,
    truncation_psi: Optional[float],
    compute_dtype: str,
    vgg_weights: Optional[str],
    seed: int,
    device: str,
    log: Optional[str],
) -> None:
    """Perceptual Path Length of a network's latent space."""
    add_log_file(Path(log) if log else None)
    import torch

    from gance_tpu_torch.metrics.ppl import perceptual_path_length
    from gance_tpu_torch.models.pickle_loader import load_generator

    params, config = load_generator(Path(network))
    result = perceptual_path_length(
        params,
        config,
        _perceptual_params(vgg_weights),
        num_samples=num_samples,
        batch_size=batch_size,
        space=space,
        sampling=sampling,
        epsilon=epsilon,
        crop=crop,
        truncation_psi=truncation_psi,
        compute_dtype=torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32,
        seed=seed,
        device=device,
    )
    print(
        json.dumps(
            {
                "metric": f"ppl_{space}_{sampling}",
                "value": result.ppl,
                "num_samples": result.num_samples,
                "num_filtered": result.num_filtered,
                "epsilon": result.epsilon,
                "crop": result.crop,
                "network": str(network),
                "perceptual": "vgg-weights" if vgg_weights else "random-vgg",
            }
        )
    )


@cli.command()
@click.option("--network", type=click.Path(exists=True, dir_okay=False), required=True)
@click.option(
    "--dataset-directory", type=click.Path(exists=True, file_okay=False), required=True,
    help="Real images to compare against (e.g. the training set).",
)
@click.option("--num-samples", type=click.IntRange(min=2), default=2048)
@click.option("--batch-size", type=click.IntRange(min=1), default=8)
@click.option(
    "--truncation-psi", type=float, default=None,
    help="Sampling truncation for the generated side; default: untruncated "
    "(FID convention). Pass the serving psi (1.2) to measure the delivered "
    "truncated distribution instead.",
)
@click.option(
    "--vgg-weights", type=click.Path(exists=True, dir_okay=False), default=None,
    help="Feature-extractor weights (see ppl --vgg-weights). Distances are "
    "comparable only within one feature configuration, NOT published-FID "
    "numbers.",
)
@click.option("--seed", type=int, default=0)
@_DEVICE_OPTION
@click.option("--log", type=click.Path(dir_okay=False), default=None)
def frechet(
    network: str,
    dataset_directory: str,
    num_samples: int,
    batch_size: int,
    truncation_psi: Optional[float],
    vgg_weights: Optional[str],
    seed: int,
    device: str,
    log: Optional[str],
) -> None:
    """Fréchet feature distance: network samples vs an image folder."""
    add_log_file(Path(log) if log else None)
    from gance_tpu_torch.metrics.frechet import frechet_distance_network_vs_images
    from gance_tpu_torch.models.pickle_loader import load_generator

    params, config = load_generator(Path(network))
    result = frechet_distance_network_vs_images(
        params,
        config,
        _perceptual_params(vgg_weights),
        Path(dataset_directory),
        num_samples=num_samples,
        batch_size=batch_size,
        truncation_psi=truncation_psi,
        seed=seed,
        device=device,
    )
    print(
        json.dumps(
            {
                "metric": "frechet_feature_distance",
                "value": result["distance"],
                "num_fake": result["num_fake"],
                "num_real": result["num_real"],
                "feature_dim": result["feature_dim"],
                "network": str(network),
                "dataset": str(dataset_directory),
                "perceptual": "vgg-weights" if vgg_weights else "random-vgg",
                "note": result["note"],
            }
        )
    )


if __name__ == "__main__":
    cli()
