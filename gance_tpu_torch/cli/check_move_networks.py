"""
CLI: validate network pickles and copy the good ones into a production
directory with the port (the counterpart of gance_tpu/cli/check_move_networks.py,
with the same options plus --device; the body is
`pipelines/check_move_networks.py`).

    python -m gance_tpu_torch.cli.check_move_networks \
        --network-directory run1 --network-directory run2 --output-directory prod
"""

from pathlib import Path
from typing import Tuple

import click


@click.command()
@click.option(
    "--network-directory", "--networks-directory", "networks_directory",
    type=click.Path(exists=True, file_okay=False),
    multiple=True, required=True,
    help="Directories scanned for *.pkl networks (reference spelling: "
    "--network-directory; --networks-directory kept as an alias).",
)
@click.option("--output-directory", type=click.Path(file_okay=False), required=True)
@click.option(
    "--device", type=str, default="cuda", show_default=True,
    help="Torch device for the check's render ('cuda' or 'cpu').",
)
def cli(networks_directory: Tuple[str, ...], output_directory: str, device: str) -> None:
    """Validate + copy networks."""
    from gance_tpu_torch.pipelines.check_move_networks import check_move_networks_api

    check_move_networks_api(
        [Path(d) for d in networks_directory], Path(output_directory), device=device
    )


if __name__ == "__main__":
    cli()
