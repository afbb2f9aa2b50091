"""
CLI: training-set preparation with the port (the counterpart of
gance_tpu/cli/process_images.py; reference process_images.py): scale images to
the training resolution, scan for and delete broken images, and run the
face-prioritized selection + copy. Host-only: no device is used.

    python -m gance_tpu_torch.cli.process_images scale-images \
        --original-images-directory raw --output-directory scaled
    python -m gance_tpu_torch.cli.process_images scan-for-broken-images --directory scaled
    python -m gance_tpu_torch.cli.process_images select-images-copy \
        --primary-directory day1 --target-num-images 100 --destination-directory picked

Option names are drop-in compatible with the reference CLI
(`--original-images-directory`, `--scaled-image-width/height`, `--no-delete`,
`--target-num-images`, `--destination-directory`, `--summary`); the shorter
spellings this framework introduced in earlier releases remain as aliases.
"""

import json
import shutil
from pathlib import Path
from typing import Optional, Tuple

import click

from gance_tpu_torch.utils.logging import LOGGER

# Reference process_images.py:23-24.
DEFAULT_IMAGE_WIDTH = 1024
DEFAULT_IMAGE_HEIGHT = 1024


@click.group()
def cli() -> None:
    """Prepare image datasets for training."""


@cli.command(name="scale-images")
@click.option(
    "--original-images-directory", "--input-directory", "original_images_directory",
    type=click.Path(exists=True, file_okay=False), required=True,
    help="A directory containing the images to scale.",
)
@click.option(
    "--image-file-extension", type=str, default="jpeg", show_default=True,
    help="The file extension for the images in original-images-directory.",
)
@click.option(
    "--output-directory", type=click.Path(file_okay=False), required=True,
    help="The directory the scaled images will be placed in.",
)
@click.option(
    "--scaled-image-width", type=click.IntRange(min=1),
    default=DEFAULT_IMAGE_WIDTH, show_default=True,
    help="The width of the scaled image.",
)
@click.option(
    "--scaled-image-height", type=click.IntRange(min=1),
    default=DEFAULT_IMAGE_HEIGHT, show_default=True,
    help="The height of the scaled image.",
)
@click.option(
    "--side-length", type=click.IntRange(min=1), default=None,
    help="Convenience: set both scaled dimensions to one square side.",
)
def scale_images(
    original_images_directory: str,
    image_file_extension: str,
    output_directory: str,
    scaled_image_width: int,
    scaled_image_height: int,
    side_length: Optional[int],
) -> None:
    """
    Scale images to the training resolution (reference process_images.py:103-127).
    Outputs keep the reference's `{width}_{height}_{original name}` naming.
    """
    import cv2

    from gance_tpu_torch.media.images import read_image, write_image

    if side_length is not None:
        scaled_image_width = scaled_image_height = side_length

    out_dir = Path(output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    extension = image_file_extension.lstrip(".").lower()
    count = 0
    for path in sorted(Path(original_images_directory).glob(f"*.{extension}")):
        try:
            image = read_image(path)
        except Exception as e:
            LOGGER.warning("Skipping unreadable image %s: %s", path, e)
            continue
        resized = cv2.resize(
            image, (scaled_image_width, scaled_image_height),
            interpolation=cv2.INTER_CUBIC,
        )
        write_image(
            resized,
            out_dir / f"{scaled_image_width}_{scaled_image_height}_{path.name}",
        )
        count += 1
    if count == 0 and any(Path(original_images_directory).iterdir()):
        # the default extension filter is the reference's 'jpeg': say so
        # rather than scale nothing silently
        LOGGER.warning(
            "Scaled 0 images: nothing in %s matches '*.%s' "
            "(set --image-file-extension).",
            original_images_directory,
            extension,
        )
    LOGGER.info(
        "Scaled %d images to %dx%d", count, scaled_image_width, scaled_image_height
    )


@cli.command(name="scan-for-broken-images")
@click.option(
    "--directory", type=click.Path(exists=True, file_okay=False), required=True,
    help="Each image here is opened with PIL; broken ones are deleted.",
)
@click.option(
    "--no-delete", is_flag=True, default=False, show_default=True,
    help="If given, the files will not be deleted, only listed.",
)
@click.option(
    "--image-file-extension", type=str, default="jpeg", show_default=True,
    help="The file extension to scan (the reference scans *.jpeg).",
)
def scan_for_broken_images(
    directory: str, no_delete: bool, image_file_extension: str
) -> None:
    """
    Find (and by default delete) unreadable images (reference
    process_images.py:146-190: deletion is the default; --no-delete lists only).
    """
    from PIL import Image

    extension = image_file_extension.lstrip(".").lower()
    broken = []
    for path in sorted(Path(directory).glob(f"*.{extension}")):
        try:
            with Image.open(str(path)) as img:
                img.load()
        except Exception as e:
            LOGGER.warning("Broken image %s: %s", path, e)
            broken.append(path)
    LOGGER.info("Found %d broken images.", len(broken))
    if not no_delete:
        for path in broken:
            LOGGER.info("Deleting: %s", path)
            path.unlink()


@cli.command(name="select-images-copy")
@click.option(
    "--primary-directory", type=click.Path(exists=True, file_okay=False),
    multiple=True, required=True,
    help="Face images here are selected above all others.",
)
@click.option(
    "--secondary-directory", type=click.Path(exists=True, file_okay=False),
    multiple=True,
    help="Face images here fill in when primary directories fall short.",
)
@click.option(
    "--target-num-images", "--num-images", "target_num_images",
    type=click.IntRange(min=1), default=None,
    help="Desired number of images; omitted selects every image.",
)
@click.option(
    "--destination-directory", "--output-directory", "destination_directory",
    type=click.Path(file_okay=False), default=None,
    help="Selected images are copied to this directory.",
)
@click.option(
    "--summary", type=click.Path(dir_okay=False), default=None,
    help="A summary about the selected images is written to this file.",
)
def select_images_copy(
    primary_directory: Tuple[str, ...],
    secondary_directory: Tuple[str, ...],
    target_num_images: Optional[int],
    destination_directory: Optional[str],
    summary: Optional[str],
) -> None:
    """Face-prioritized selection + copy (reference process_images.py:193-337)."""
    from gance_tpu_torch.overlay.selection import select_images_for_training

    result = select_images_for_training(
        primary_directories=[Path(p) for p in primary_directory],
        secondary_directories=[Path(p) for p in secondary_directory],
        num_images=target_num_images,
    )

    if destination_directory is not None:
        out_dir = Path(destination_directory)
        out_dir.mkdir(parents=True, exist_ok=True)
        for path in result.selected:
            shutil.copy2(path, out_dir / path.name)
        LOGGER.info("Copied %d images -> %s", len(result.selected), out_dir)

    summary_blob = {
        "num_selected": len(result.selected),
        "num_primary_faces": result.num_primary_faces,
        "num_secondary_faces": result.num_secondary_faces,
        "num_neighbors": result.num_neighbors,
        "num_random": result.num_random,
        "selected": [str(p) for p in result.selected],
    }
    if summary is not None:
        Path(summary).write_text(json.dumps(summary_blob, indent=2))
    elif destination_directory is not None:
        # Earlier releases always dropped a summary beside the copies; keep it
        # when no explicit --summary path overrides.
        (Path(destination_directory) / "selection_summary.json").write_text(
            json.dumps(summary_blob, indent=2)
        )
    LOGGER.info("Selected %d images", len(result.selected))


if __name__ == "__main__":
    cli()
