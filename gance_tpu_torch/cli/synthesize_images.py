"""
CLI: still images from networks with the port (the counterpart of
gance_tpu/cli/synthesize_images.py, with the same commands, options and
output names, plus --device).

    python -m gance_tpu_torch.cli.synthesize_images images-from-network \
        --networks-directory nets --output-directory images --num-faces 1 --no-faces 1
    python -m gance_tpu_torch.cli.synthesize_images synthesis-file-into-networks \
        --synthesis-files-dir images --networks-dir nets --output-directory replayed

  * images-from-network: per network, seeded random z filtered into face and
    face-free images by rejection sampling through the face detector,
    written as PNG + synthesis-file JSON pairs with md5 provenance;
  * synthesis-file-into-networks: the vectors of synthesis files replayed
    through every network.
The bodies are `images_from_network_api` and `synthesis_file_into_networks_api`
in `pipelines/synthesis_file.py`.
"""

from pathlib import Path
from typing import List, Optional, Tuple

import click

from gance_tpu_torch.pipelines.synthesis_file import DEFAULT_RANDOM_SEED

_DEVICE = click.option(
    "--device", type=str, default="cuda", show_default=True,
    help="Torch device for synthesis ('cuda' or 'cpu').",
)


@click.group()
def cli() -> None:
    """Create still images with networks."""


@cli.command(name="images-from-network")
@click.option(
    "--networks-directory", type=click.Path(exists=True, file_okay=False), required=True
)
@click.option("--output-directory", type=click.Path(file_okay=False), required=True)
@click.option("--num-faces", type=click.IntRange(min=0), default=1)
@click.option("--no-faces", type=click.IntRange(min=0), default=1)
@click.option("--random-seed", type=int, default=DEFAULT_RANDOM_SEED)
@_DEVICE
def images_from_network(
    networks_directory: str,
    output_directory: str,
    num_faces: int,
    no_faces: int,
    random_seed: int,
    device: str,
) -> None:
    """Generate random z images per network, filtered by face presence."""
    from gance_tpu_torch.pipelines.synthesis_file import images_from_network_api

    images_from_network_api(
        networks_directory=Path(networks_directory),
        output_directory=Path(output_directory),
        num_faces=num_faces,
        no_faces=no_faces,
        random_seed=random_seed,
        device=device,
    )


@cli.command(name="synthesis-file-into-networks")
@click.option(
    "--synthesis-files-dir", type=click.Path(exists=True, file_okay=False), default=None
)
@click.option(
    "--synthesis-file", type=click.Path(exists=True, dir_okay=False), multiple=True
)
@click.option("--networks-dir", type=click.Path(exists=True, file_okay=False), default=None)
@click.option("--network", type=click.Path(exists=True, dir_okay=False), multiple=True)
@click.option("--output-directory", type=click.Path(file_okay=False), required=True)
@_DEVICE
def synthesis_file_into_networks(
    synthesis_files_dir: Optional[str],
    synthesis_file: Tuple[str, ...],
    networks_dir: Optional[str],
    network: Tuple[str, ...],
    output_directory: str,
    device: str,
) -> None:
    """Replay synthesis-file vectors through every given network."""
    from gance_tpu_torch.models.pickle_loader import parse_network_paths
    from gance_tpu_torch.pipelines.synthesis_file import synthesis_file_into_networks_api

    synthesis_paths: List[Path] = []
    if synthesis_files_dir:
        synthesis_paths.extend(sorted(Path(synthesis_files_dir).glob("*.json")))
    synthesis_paths.extend(Path(p) for p in synthesis_file)
    if not synthesis_paths:
        raise click.UsageError("No synthesis files given.")
    network_paths = parse_network_paths(
        networks_directory=Path(networks_dir) if networks_dir else None,
        network_paths=[Path(p) for p in network] if network else None,
        networks_json=None,
    )
    synthesis_file_into_networks_api(
        synthesis_paths=synthesis_paths,
        network_paths=network_paths,
        output_directory=Path(output_directory),
        device=device,
    )


if __name__ == "__main__":
    cli()
