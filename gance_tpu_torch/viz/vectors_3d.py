"""
3D "waterfall" visualization of vector arrays (a copy of
gance_tpu/viz/vectors_3d.py, whose spectrogram panel runs the port's DSP on
`device`; reference gance/
data_into_network_visualization/vectors_3d.py): each sub-vector becomes one line of
points at its own depth, giving the classic spectrogram-waterfall view, with an
optional progress marker.
"""

from typing import Optional

import numpy as np

from gance_tpu_torch.types import VectorsLabel
from gance_tpu_torch.utils.device import Device
from gance_tpu_torch.viz.panels import render_figure_to_rgb


def reshape_vectors_for_3d_plotting(
    data: np.ndarray, vector_length: int
) -> tuple:
    """
    Vectorized (x, y, z) point clouds for the waterfall (reference :12-29 — the
    "fast reshape == naive reshape AND faster" test subject).
    """
    divided = np.asarray(data).reshape(-1, vector_length)
    num_vectors = divided.shape[0]
    x = np.tile(np.arange(vector_length), num_vectors)
    y = np.repeat(np.arange(num_vectors), vector_length)
    z = divided.reshape(-1)
    return x, y, z


def plot_vectors_3d(
    vectors_label: VectorsLabel,
    current_index: Optional[int] = None,
    side_length: int = 400,
) -> np.ndarray:
    """Render the waterfall scatter to an RGB frame (reference :32-70,:91)."""
    import matplotlib.pyplot as plt

    x, y, z = reshape_vectors_for_3d_plotting(
        vectors_label.data, vectors_label.vector_length
    )
    figure = plt.figure(figsize=(10, 10), dpi=100)
    axis = figure.add_subplot(111, projection="3d")
    axis.scatter(x, y, z, s=0.5, alpha=0.3)
    if current_index is not None:
        axis.scatter([0], [current_index], [float(z.max())], color="red", s=30)
    axis.set_title(vectors_label.label, fontsize=9)
    axis.set_xlabel("vector dim")
    axis.set_ylabel("time (vector #)")
    out = render_figure_to_rgb(figure, side_length)
    plt.close(figure)
    return out


def multi_plot_vectors(
    vectors_labels: list,
    side_length: int = 400,
) -> np.ndarray:
    """
    Side-by-side 3D comparison of several vector arrays (reference
    vectors_to_image.py:34 `multi_plot_vectors`). Returns one hconcat frame.
    """
    from gance_tpu_torch.media.images import horizontal_concat_images

    return horizontal_concat_images(
        [plot_vectors_3d(label, side_length=side_length) for label in vectors_labels]
    )


def visualize_data_with_spectrogram_and_3d_vectors(
    vectors_label: VectorsLabel,
    side_length: int = 400,
    device: Device = "cuda",
) -> np.ndarray:
    """
    [raw data plot | spectrogram | 3D waterfall] composite frame (reference
    vectors_to_image.py:63-142). The spectrogram is computed on `device`.
    """
    import matplotlib.pyplot as plt

    from gance_tpu_torch.audio.spectrogram import compute_spectrogram
    from gance_tpu_torch.audio.vectors import to_numpy
    from gance_tpu_torch.media.images import horizontal_concat_images

    # raw signal
    figure, axis = plt.subplots(1, 1, figsize=(10, 10), dpi=100)
    axis.plot(np.asarray(vectors_label.data), linewidth=0.5)
    axis.set_title(f"{vectors_label.label} (raw)", fontsize=9)
    raw = render_figure_to_rgb(figure, side_length)
    plt.close(figure)

    # spectrogram heatmap
    spectrogram = to_numpy(
        compute_spectrogram(
            np.asarray(vectors_label.data, np.float32), vectors_label.vector_length,
            device=device,
        )
    )
    figure, axis = plt.subplots(1, 1, figsize=(10, 10), dpi=100)
    axis.imshow(spectrogram, aspect="auto", origin="lower", cmap="magma")
    axis.set_title("spectrogram (dB)", fontsize=9)
    spec = render_figure_to_rgb(figure, side_length)
    plt.close(figure)

    waterfall = plot_vectors_3d(vectors_label, side_length=side_length)
    return horizontal_concat_images([raw, spec, waterfall])
