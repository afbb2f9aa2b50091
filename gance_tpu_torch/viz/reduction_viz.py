"""
Streaming visualization of reducer outputs + provenance layers (a copy of
gance_tpu/viz/reduction_viz.py, whose reducer runs on `device`; reference
gance/data_into_network_visualization/visualize_vector_reduction.py): windowed line
plots of each ResultLayers signal with a moving per-frame cursor. Used for the
music-complexity overlay-mask debug tile.
"""

from pathlib import Path
from typing import Callable, Iterator, Optional

import matplotlib.pyplot as plt
import numpy as np

from gance_tpu_torch.types import ResultLayers
from gance_tpu_torch.utils.device import Device
from gance_tpu_torch.viz.panels import render_figure_to_rgb


def visualize_reducer_output(
    audio_path: Path,
    reducer: Callable[..., ResultLayers],
    output_image_path: Optional[Path] = None,
    vector_length: int = 1000,
    num_networks: int = 30,
    device: Device = "cuda",
) -> np.ndarray:
    """
    One-shot reducer demo (reference visualize_vector_reduction.py:26-83): run a
    reducer over an audio file, quantize into `num_networks` indices, and plot the
    compositional layers above the quantized result. Saves to
    `output_image_path` when given (headless-friendly), else opens the
    interactive matplotlib window like the reference. Returns the rendered frame.
    The reducer and the quantization run on `device`.
    """
    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.audio.reduction import quantize_results_layers

    audio = read_wavs_scale_for_video(
        wavs=[Path(audio_path)], vector_length=vector_length, frames_per_second=60.0
    ).wav_data
    reduced = quantize_results_layers(
        reducer(time_series_audio_vectors=audio, vector_length=vector_length, device=device),
        network_indices=list(range(num_networks)),
        device=device,
    )

    figure = plt.figure(figsize=(10, 10), dpi=100)
    grid = figure.add_gridspec(nrows=4)
    layers_axis = figure.add_subplot(grid[0:3, :])
    result_axis = figure.add_subplot(grid[3:4, :])

    x_values = np.arange(len(np.asarray(reduced.result.data)))
    for layer in reduced.layers:
        layers_axis.plot(
            x_values, np.asarray(layer.data, dtype=float), alpha=0.5, label=layer.label
        )
    layers_axis.legend(loc="upper right", fontsize=6)
    layers_axis.set_title("Compositional Layers")
    layers_axis.set_ylabel("Signal Amplitude")

    result_axis.plot(x_values, np.asarray(reduced.result.data))
    result_axis.set_title("Quantized Result")
    result_axis.set_ylabel("Network Index")
    result_axis.set_xlabel("Frame #")
    figure.suptitle(f"Network selection for {Path(audio_path).name}")

    rendered = render_figure_to_rgb(figure)
    if output_image_path is not None:
        figure.savefig(str(output_image_path))
        plt.close(figure)
    else:  # pragma: no cover - interactive path
        plt.show()
    return rendered


def visualize_result_layers(
    result_layers: ResultLayers,
    frames_per_context: int,
    video_height: int,
    title: str = "",
    horizontal_line: Optional[float] = None,
) -> Iterator[np.ndarray]:
    """
    Yield one debug frame per sample: the result + layer signals plotted in windows
    of `frames_per_context`, with a red cursor at the current frame.
    """
    signals = [result_layers.result] + list(result_layers.layers)
    length = len(np.asarray(result_layers.result.data))

    for frame_index in range(length):
        window_start = (frame_index // frames_per_context) * frames_per_context
        window_end = min(window_start + frames_per_context, length)
        xs = np.arange(window_start, window_end)

        figure, axis = plt.subplots(1, 1, figsize=(10, 10), dpi=100)
        for signal in signals:
            data = np.asarray(signal.data, dtype=float)
            axis.plot(xs, data[window_start:window_end], label=signal.label, linewidth=1)
        if horizontal_line is not None:
            axis.axhline(horizontal_line, color="black", linestyle="--", linewidth=1)
        axis.axvline(frame_index, color="red", linewidth=1)
        axis.set_title(title, fontsize=9)
        axis.legend(fontsize=6)
        axis.tick_params(labelsize=6)

        out = render_figure_to_rgb(figure, video_height)
        plt.close(figure)
        yield out
