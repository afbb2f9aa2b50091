"""
Synthesis orchestration: VisualizationInput -> (synthesized frames, debug-viz
frames). The counterpart of gance_tpu/synthesis/orchestration.py (reference:
gance/data_into_network_visualization/network_visualization.py
`vector_synthesis`):

  * frame slicing is an array reshape (per-frame FrameInput objects exist only
    for the debug visualizer);
  * synthesis runs through the port's MultiNetwork.synthesize_stream (batched
    on the device, in frame order);
  * the viz stream draws from the same host-side arrays independently.
"""

from itertools import islice
from typing import Callable, Iterator, List, NamedTuple, Optional

import numpy as np

from gance_tpu_torch.audio.vectors import sub_vectors
from gance_tpu_torch.synthesis.inputs import VisualizationInput, slice_visualization_input
from gance_tpu_torch.synthesis.runtime import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_STREAM_LOOKAHEAD,
    MultiNetwork,
)
from gance_tpu_torch.utils.profiling import timed_iterator


class FrameInput(NamedTuple):
    """
    Everything the debug visualizer needs about one output frame (reference
    visualization_common.py:89-117).
    """

    frame_index: int
    vector_length: int
    a_sample: np.ndarray  # (V,) or (R, V)
    b_sample: np.ndarray
    combined_sample: np.ndarray
    network_index: Optional[int]
    # window of indices around this frame for the context plot
    index_window: np.ndarray
    index_window_start: int


class SynthesisOutput(NamedTuple):
    """Lazy frame streams (reference network_visualization.py:403)."""

    synthesized_images: Iterator[np.ndarray]
    visualization_images: Optional[Iterator[np.ndarray]]


def _divided(data: np.ndarray, vector_length: int) -> np.ndarray:
    """(N, V) for vectors or (N, R, V) for matrices."""
    return sub_vectors(np.asarray(data), vector_length)


def frame_inputs(
    data: VisualizationInput,
    frames_to_visualize: Optional[int] = None,
    network_index_window_width: int = 100,
) -> List[FrameInput]:
    """
    Slice a VisualizationInput into per-frame views (reference `_frame_inputs`,
    network_visualization.py:160-251). Count = min over streams, optionally capped.
    """
    vector_length = data.combined.vector_length
    a = _divided(data.a_vectors.data, vector_length)
    b = _divided(data.b_vectors.data, vector_length)
    combined = _divided(data.combined.data, vector_length)
    indices = np.asarray(data.network_indices.result.data)

    count = min(a.shape[0], b.shape[0], combined.shape[0], indices.shape[0])
    if frames_to_visualize is not None:
        count = min(count, frames_to_visualize)

    half = network_index_window_width // 2
    out = []
    for i in range(count):
        lo = max(0, i - half)
        hi = min(count, i + half)
        out.append(
            FrameInput(
                frame_index=i,
                vector_length=vector_length,
                a_sample=a[i],
                b_sample=b[i],
                combined_sample=combined[i],
                network_index=int(indices[i]),
                index_window=indices[lo:hi],
                index_window_start=lo,
            )
        )
    return out


def vector_synthesis(
    networks: MultiNetwork,
    data: VisualizationInput,
    frames_to_visualize: Optional[int] = None,
    batch_size: int = DEFAULT_BATCH_SIZE,
    visualizer: Optional[Callable[[FrameInput], np.ndarray]] = None,
    unload_networks_when_complete: bool = False,
) -> SynthesisOutput:
    """
    Drive batched synthesis over the combined stream with per-frame network
    selection; optionally produce a parallel debug-visualization frame stream.

    :param visualizer: host callback rendering one debug frame per FrameInput
        (None disables the viz stream).
    :param unload_networks_when_complete: drop network params after the synthesis
        stream is exhausted (frees device memory).
    """
    vector_length = data.combined.vector_length
    combined = _divided(data.combined.data, vector_length)
    indices = np.asarray(data.network_indices.result.data).astype(int)

    count = min(combined.shape[0], indices.shape[0])
    if frames_to_visualize is not None:
        count = min(count, frames_to_visualize)
    combined = combined[:count]
    indices = np.clip(indices[:count], 0, max(len(networks) - 1, 0))

    def synthesized() -> Iterator[np.ndarray]:
        yield from timed_iterator(
            "synthesis",
            networks.synthesize_stream(combined, indices, batch_size=batch_size),
        )
        if unload_networks_when_complete:
            networks.unload()

    visualization: Optional[Iterator[np.ndarray]] = None
    if visualizer is not None:
        frames = frame_inputs(data, frames_to_visualize=count)

        def visualized() -> Iterator[np.ndarray]:
            for frame in frames:
                yield visualizer(frame)

        visualization = visualized()

    return SynthesisOutput(
        synthesized_images=synthesized(), visualization_images=visualization
    )


def resumed_synthesis(
    networks: MultiNetwork,
    data: VisualizationInput,
    first: int,
    total: int,
    unload_networks_when_complete: bool = False,
) -> Iterator[np.ndarray]:
    """
    Frames [first, total) of `vector_synthesis(networks, data)`, for a render
    that resumes at frame `first`. Synthesis starts at the stream window
    (`synthesize_stream`'s batch * lookahead frames) at or before `first` and
    the frames before `first` are dropped, so that every frame is computed in
    the same batch as in an unbroken render: a GPU's convolution algorithms
    may sum in another order for another batch, and a resumed render must
    equal an unbroken one bit for bit. gance_tpu slices at `first` itself.
    """
    window = DEFAULT_BATCH_SIZE * max(DEFAULT_STREAM_LOOKAHEAD, 1)
    start = first - first % window
    output = vector_synthesis(
        networks=networks,
        data=slice_visualization_input(data, start),
        frames_to_visualize=total - start,
        unload_networks_when_complete=unload_networks_when_complete,
    )
    return islice(output.synthesized_images, first - start, None)
