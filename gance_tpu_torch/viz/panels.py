"""
Per-frame synthesis debug panels (a copy of gance_tpu/viz/panels.py, host-only:
matplotlib and cv2; reference network_visualization.py:54-400 +
visualization_common.py:133-176 + vectors_to_image.py).

`synthesis_visualizer` returns the per-FrameInput callback consumed by
gance_tpu_torch.synthesis.orchestration.vector_synthesis: it draws the A/B/combined
vector scatters, the network-index context window with a current-frame cursor, and
the current index bar, then rasterizes to a square RGB frame.
"""

from typing import Callable, Optional

import cv2
import matplotlib.pyplot as plt
import numpy as np

from gance_tpu_torch.synthesis.orchestration import FrameInput


def render_figure_to_rgb(figure: "plt.Figure", side_length: Optional[int] = None) -> np.ndarray:
    """Rasterize a figure to an RGB uint8 array, optionally resized to a square."""
    figure.canvas.draw()
    buffer = np.asarray(figure.canvas.buffer_rgba())[..., :3].copy()
    if side_length is not None:
        buffer = cv2.resize(
            buffer, (side_length, side_length), interpolation=cv2.INTER_AREA
        )
    return buffer


def _scatter_sample(axis: "plt.Axes", sample: np.ndarray, title: str, color: str) -> None:
    sample = np.asarray(sample)
    if sample.ndim == 1:
        axis.scatter(np.arange(sample.shape[0]), sample, s=1, color=color)
    else:
        for row in sample:
            axis.scatter(np.arange(row.shape[0]), row, s=1, color=color, alpha=0.4)
    axis.set_title(title, fontsize=8)
    axis.tick_params(labelsize=6)


def synthesis_visualizer(
    side_length: int = 400,
    a_label: str = "A",
    b_label: str = "B",
    combined_label: str = "Combined",
    waterfall_vectors: Optional[object] = None,
) -> Callable[[FrameInput], np.ndarray]:
    """
    Build the per-frame debug renderer: the 2x2 panel layout, plus — when
    `waterfall_vectors` (a VectorsLabel of the full combined stream) is given — a
    third column with the 3D waterfall of the whole run and a red progress marker
    at the current frame (the reference's optional enable_3d panel,
    network_visualization.py:542-596).
    """
    waterfall_points = None
    if waterfall_vectors is not None:
        from gance_tpu_torch.viz.vectors_3d import reshape_vectors_for_3d_plotting

        # reshape once; per-frame rendering only moves the progress marker.
        # Matrices (rows, N*V) waterfall their first style row — the blended one.
        data = np.asarray(waterfall_vectors.data)
        if data.ndim == 2:
            data = data[0]
        waterfall_points = reshape_vectors_for_3d_plotting(
            data, waterfall_vectors.vector_length
        )

    def render(frame: FrameInput) -> np.ndarray:
        if waterfall_points is None:
            figure, axes2d = plt.subplots(2, 2, figsize=(10, 10), dpi=100)
            axes = [axes2d[0][0], axes2d[0][1], axes2d[1][0], axes2d[1][1]]
        else:
            figure = plt.figure(figsize=(15, 10), dpi=100)
            grid = figure.add_gridspec(2, 3)
            axes = [
                figure.add_subplot(grid[0, 0]),
                figure.add_subplot(grid[0, 1]),
                figure.add_subplot(grid[1, 0]),
                figure.add_subplot(grid[1, 1]),
            ]
            x, y, z = waterfall_points
            waterfall_axis = figure.add_subplot(grid[:, 2], projection="3d")
            waterfall_axis.scatter(x, y, z, s=0.5, alpha=0.3)
            waterfall_axis.scatter(
                [0], [frame.frame_index], [float(z.max())], color="red", s=30
            )
            waterfall_axis.set_title(
                getattr(waterfall_vectors, "label", "combined"), fontsize=8
            )
            waterfall_axis.set_xlabel("vector dim", fontsize=6)
            waterfall_axis.set_ylabel("time (frame #)", fontsize=6)
            waterfall_axis.tick_params(labelsize=5)

        _scatter_sample(axes[0], frame.a_sample, a_label, "tab:blue")
        _scatter_sample(axes[1], frame.b_sample, b_label, "tab:orange")
        _scatter_sample(axes[2], frame.combined_sample, combined_label, "tab:green")

        index_axis = axes[3]
        window_x = np.arange(
            frame.index_window_start, frame.index_window_start + len(frame.index_window)
        )
        index_axis.step(window_x, frame.index_window, where="mid", color="tab:purple")
        index_axis.axvline(frame.frame_index, color="red", linewidth=1)
        index_axis.set_title(
            f"Network index (current: {frame.network_index})", fontsize=8
        )
        index_axis.tick_params(labelsize=6)

        figure.suptitle(f"Frame {frame.frame_index}", fontsize=10)
        out = render_figure_to_rgb(figure, side_length)
        plt.close(figure)
        return out

    return render


def vector_visualizer(
    y_range: tuple = (-6.0, 6.0), title: str = "", output_width: int = 400,
    output_height: int = 400,
) -> Callable[[np.ndarray], np.ndarray]:
    """
    Render a single vector or matrix as a scatter frame (reference
    vectors_to_image.py:167-219 `vector_visualizer`).
    """

    def render(data: np.ndarray) -> np.ndarray:
        figure, axis = plt.subplots(1, 1, figsize=(10, 10), dpi=100)
        _scatter_sample(axis, data, title, "tab:blue")
        axis.set_ylim(*y_range)
        rgb = render_figure_to_rgb(figure)
        plt.close(figure)
        return cv2.resize(
            rgb, (output_width, output_height), interpolation=cv2.INTER_AREA
        )

    return render


def vectors_to_video(
    data: np.ndarray,
    vector_length: int,
    output_path: "object",
    video_fps: float = 30.0,
    side_length: int = 400,
) -> None:
    """Render every sub-vector of a flat array as a video (reference :222-259)."""
    from gance_tpu_torch.media.video import write_source_to_disk_consume

    divided = np.asarray(data).reshape(-1, vector_length)
    render = vector_visualizer(
        y_range=(float(divided.min()), float(divided.max())),
        output_width=side_length,
        output_height=side_length,
    )
    write_source_to_disk_consume(
        (render(vector) for vector in divided), output_path, video_fps
    )
