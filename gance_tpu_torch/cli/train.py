"""
CLI: train StyleGAN2 on an image folder with the port, with crash-resume.

The counterpart of gance_tpu/cli/train.py on one device (`--device cuda` by
default, `--device cpu` to run on the CPU): the loop is
`parallel/training.py::run_training` over `parallel/data.py`'s streaming
dataset. It checkpoints every N steps, resumes from the checkpoint
automatically, and exports the EMA generator as an NVlabs-format .pkl that
both packages load.

    python -m gance_tpu_torch.cli.train --dataset-directory images \
        --resolution 64 --checkpoint-path ckpt.pkl --output-network net.pkl

Not ported yet, so absent here: --data-parallel and --dist-* (ROADMAP.md
Queue 1 item 12), --remat and --scan-segment (item 11), --metrics-* (item 10).
"""

import json
from pathlib import Path
from typing import Optional

import click


@click.command()
@click.option("--dataset-directory", type=click.Path(exists=True, file_okay=False), required=True)
@click.option("--resolution", type=click.IntRange(min=16), default=64)
@click.option("--batch-size", type=click.IntRange(min=1), default=8)
@click.option("--total-steps", type=click.IntRange(min=1), default=1000)
@click.option("--learning-rate", type=float, default=0.002)
@click.option("--r1-gamma", type=float, default=10.0)
@click.option(
    "--pl-weight", type=float, default=2.0,
    help="Path-length regularization weight (config-f's G regularizer); 0 disables it.",
)
@click.option("--fmap-base", type=int, default=None, help="Defaults to config-f scaling.")
@click.option("--fmap-max", type=int, default=512)
@click.option("--latent-size", type=int, default=512)
@click.option(
    "--checkpoint-path", type=click.Path(dir_okay=False), required=True,
    help="Checkpoint file; training resumes from it automatically when it exists.",
)
@click.option("--checkpoint-every", type=click.IntRange(min=1), default=200)
@click.option(
    "--output-network", type=click.Path(dir_okay=False), required=True,
    help="Write the EMA generator here as an NVlabs-format .pkl.",
)
@click.option(
    "--compute-dtype", type=click.Choice(["float32", "bfloat16"]), default="float32",
    help="bfloat16: bf16 forward and backward, fp32 master weights, Adam, EMA and losses.",
)
@click.option("--seed", type=int, default=0)
@click.option("--device", type=str, default="cuda", show_default=True,
              help="Torch device to train on ('cuda' or 'cpu').")
@click.option(
    "--run-config", type=click.Path(dir_okay=False), default=None,
    help="Dump the resolved CLI arguments to this JSON path.",
)
@click.option("--log", type=click.Path(dir_okay=False), default=None)
def cli(  # pylint: disable=too-many-arguments,too-many-locals
    dataset_directory: str,
    resolution: int,
    batch_size: int,
    total_steps: int,
    learning_rate: float,
    r1_gamma: float,
    pl_weight: float,
    fmap_base: Optional[int],
    fmap_max: int,
    latent_size: int,
    checkpoint_path: str,
    checkpoint_every: int,
    output_network: str,
    compute_dtype: str,
    seed: int,
    device: str,
    run_config: Optional[str],
    log: Optional[str],
) -> None:
    """Train StyleGAN2 on an image folder (resumable; exports a loadable .pkl)."""
    arguments = dict(locals())
    if run_config is not None:
        Path(run_config).write_text(json.dumps(arguments, indent=2))

    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel.data import StreamingImageDataset
    from gance_tpu_torch.parallel.training import TrainingConfig, run_training
    from gance_tpu_torch.utils.logging import add_log_file

    add_log_file(Path(log) if log else None)
    model_config = GeneratorConfig(
        resolution=resolution,
        fmap_base=fmap_base if fmap_base is not None else 32768,
        fmap_max=fmap_max,
        latent_size=latent_size,
        dlatent_size=latent_size,
        mapping_fmaps=latent_size,
    )
    train_config = TrainingConfig(
        learning_rate=learning_rate, r1_gamma=r1_gamma, pl_weight=pl_weight,
        compute_dtype=compute_dtype,
    )
    # the batch of step s is a function of (seed + 1, s), as in gance_tpu's CLI
    dataset = StreamingImageDataset(Path(dataset_directory), resolution, seed=seed + 1)
    run_training(
        dataset, model_config, train_config, Path(checkpoint_path), total_steps, batch_size,
        checkpoint_every=checkpoint_every, output_network=Path(output_network), seed=seed,
        device=device,
    )


if __name__ == "__main__":
    cli()
