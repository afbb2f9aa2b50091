"""
One-shot quick-look helpers: a [vector scatter | synthesis output] pair as a
video or a single image (a copy of gance_tpu/viz/one_shot.py over the port's
SynthesisNetwork).

Reference: data_into_network_visualization/network_visualization.py:704-758
(`vectors_single_network_visualization`) and :761-800
(`single_vector_single_network_visualization`) — the reference's quick-look API
for understanding what a set of vectors does to a network.

The reference synthesizes one frame per `create_image_vector` call; here
frames go through the network in batches of 8 (`images_from_vectors`), as in
gance_tpu, so the device sees batched dispatches while matplotlib renders the
scatter panels on the host.
"""

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gance_tpu_torch.audio.vectors import sub_vectors
from gance_tpu_torch.media.images import write_image
from gance_tpu_torch.media.video import create_video_writer
from gance_tpu_torch.types import ImageResolution, VectorsLabel
from gance_tpu_torch.utils.logging import LOGGER
from gance_tpu_torch.viz.panels import vector_visualizer

_SYNTHESIS_BATCH = 8


def _y_bounds(
    data: np.ndarray, y_range: Optional[Tuple[float, float]]
) -> Tuple[float, float]:
    """Explicit y range if given, else the data's min/max (reference :693-701)."""
    if y_range is not None:
        return y_range
    data = np.asarray(data)
    return float(data.min()), float(data.max())


def _scaled_to_height(image: np.ndarray, height: int) -> np.ndarray:
    """Resize a square synthesis output to the panel height (host-side, cheap)."""
    if image.shape[0] == height:
        return image
    import cv2

    return cv2.resize(image, (height, height), interpolation=cv2.INTER_AREA)


def vectors_single_network_visualization(
    vectors_label: VectorsLabel,
    output_video_path: Path,
    network: "object",
    video_height: int = 1024,
    y_range: Optional[Tuple[float, float]] = None,
    video_fps: float = 60.0,
) -> None:
    """
    Write a video whose left half is a scatter plot of the current vector and
    whose right half is the network's output for that vector (reference :704-758).

    :param vectors_label: the vectors to visualize/synthesize (flat data divided
        into `network.expected_vector_length` chunks).
    :param network: a SynthesisNetwork-like object (images_from_vectors).
    :param video_height: output height; the video is 2x as wide.
    """
    y_min, y_max = _y_bounds(vectors_label.data, y_range)
    make_visualization = vector_visualizer(
        y_range=(y_min, y_max),
        title=vectors_label.label,
        output_width=video_height,
        output_height=video_height,
    )

    all_vectors = sub_vectors(
        np.asarray(vectors_label.data), network.expected_vector_length
    )
    num_vectors = len(all_vectors)
    writer = create_video_writer(
        video_path=Path(output_video_path),
        video_fps=video_fps,
        resolution=ImageResolution(width=2 * video_height, height=video_height),
    )

    # Batched synthesis: dispatch a window to the device, then render its
    # scatter panels while the next window computes.
    for start in range(0, num_vectors, _SYNTHESIS_BATCH):
        window = np.asarray(all_vectors[start : start + _SYNTHESIS_BATCH])
        images = network.images_from_vectors(window)
        for offset, (vector, image) in enumerate(zip(window, images)):
            LOGGER.info(
                "Writing video: %s, frame: %d/%d",
                Path(output_video_path).name,
                start + offset,
                num_vectors,
            )
            panel = make_visualization(vector)
            frame = np.concatenate(
                [panel, _scaled_to_height(image, video_height)], axis=1
            )
            writer.write(frame.astype(np.uint8))
    writer.finish()


def single_vector_single_network_visualization(
    vector: np.ndarray,
    title: str,
    output_image_path: Path,
    network: "object",
    image_height: int = 1024,
    y_range: Optional[Tuple[float, float]] = None,
) -> None:
    """
    Write a single [scatter | synthesis] image for one vector (reference
    :761-800).
    """
    vector = np.asarray(vector)
    y_min, y_max = _y_bounds(vector, y_range)
    make_visualization = vector_visualizer(
        y_range=(y_min, y_max),
        title=title,
        output_width=image_height,
        output_height=image_height,
    )
    panel = make_visualization(vector)
    image = network.create_image_generic(vector)
    frame = np.concatenate([panel, _scaled_to_height(image, image_height)], axis=1)
    write_image(frame.astype(np.uint8), Path(output_image_path))
