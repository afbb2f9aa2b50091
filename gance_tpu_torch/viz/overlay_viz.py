"""
Overlay-decision visualization (a copy of gance_tpu/viz/overlay_viz.py over
the port's OverlayContext; reference gance/overlay/overlay_visualization.py):
windowed scatter of the per-frame phash/bbox distances with threshold lines and a
green/red cursor showing whether the overlay was written.
"""

from typing import Iterator, List, NamedTuple, Optional

import matplotlib.pyplot as plt
import numpy as np

from gance_tpu_torch.overlay.eye_tracking import OverlayContext
from gance_tpu_torch.viz.panels import render_figure_to_rgb


class VisualizeOverlayThresholds(NamedTuple):
    """The gating thresholds drawn as horizontal lines (reference :41)."""

    phash_line: float
    bbox_distance_line: float


def visualize_overlay_computation(
    overlay: "Iterator[OverlayContext]",
    frames_per_context: int,
    video_square_side_length: int,
    horizontal_lines: Optional[VisualizeOverlayThresholds] = None,
) -> Iterator[np.ndarray]:
    """Yield one debug frame per overlay context (consumes the context stream)."""
    contexts: List[OverlayContext] = list(overlay)
    length = len(contexts)
    phash = np.array(
        [
            c.bbox_perceptual_hash_distance
            if c.bbox_perceptual_hash_distance is not None
            else np.nan
            for c in contexts
        ],
        dtype=float,
    )
    bbox = np.array(
        [c.bbox_distance if c.bbox_distance is not None else np.nan for c in contexts],
        dtype=float,
    )

    for frame_index in range(length):
        window_start = (frame_index // frames_per_context) * frames_per_context
        window_end = min(window_start + frames_per_context, length)
        xs = np.arange(window_start, window_end)

        figure, (hash_axis, bbox_axis) = plt.subplots(2, 1, figsize=(10, 10), dpi=100)
        hash_axis.scatter(xs, phash[window_start:window_end], s=6, color="tab:blue")
        hash_axis.set_title("Eye-crop pHash distance", fontsize=8)
        bbox_axis.scatter(xs, bbox[window_start:window_end], s=6, color="tab:orange")
        bbox_axis.set_title("Eye bbox center distance (px)", fontsize=8)
        if horizontal_lines is not None:
            hash_axis.axhline(horizontal_lines.phash_line, color="black", linestyle="--")
            bbox_axis.axhline(
                horizontal_lines.bbox_distance_line, color="black", linestyle="--"
            )
        cursor_color = "green" if contexts[frame_index].overlay_written else "red"
        for axis in (hash_axis, bbox_axis):
            axis.axvline(frame_index, color=cursor_color, linewidth=1)
            axis.tick_params(labelsize=6)

        out = render_figure_to_rgb(figure, video_square_side_length)
        plt.close(figure)
        yield out
