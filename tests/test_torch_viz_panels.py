"""
The port's debug panels (gance_tpu_torch/viz/) against gance_tpu's on the
same numpy inputs, pixel for pixel: both draw with the same matplotlib on
the host, so any difference is a difference in what is drawn. The inputs
are seeded numpy arrays and a fabricated percussive WAV; the reducer demo's
DSP runs on the CPU through the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
pytest.importorskip("cv2")

from gance_tpu import types as jax_types  # noqa: E402
from gance_tpu.audio import reduction as jax_reduction  # noqa: E402
from gance_tpu.overlay.eye_tracking import OverlayContext as JaxOverlayContext  # noqa: E402
from gance_tpu.synthesis.orchestration import FrameInput as JaxFrameInput  # noqa: E402
from gance_tpu.viz import overlay_viz as jax_overlay_viz  # noqa: E402
from gance_tpu.viz import panels as jax_panels  # noqa: E402
from gance_tpu.viz import reduction_viz as jax_reduction_viz  # noqa: E402
from gance_tpu.viz import vectors_3d as jax_vectors_3d  # noqa: E402
from gance_tpu_torch import types as port_types  # noqa: E402
from gance_tpu_torch.audio import reduction as port_reduction  # noqa: E402
from gance_tpu_torch.audio.io import fabricate_percussive_wav  # noqa: E402
from gance_tpu_torch.overlay.eye_tracking import OverlayContext  # noqa: E402
from gance_tpu_torch.synthesis.orchestration import FrameInput  # noqa: E402
from gance_tpu_torch.viz import overlay_viz, panels, reduction_viz, vectors_3d  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

V = 32  # vector length
SIDE = 96  # panel side


def frame_input(cls, rng: np.random.RandomState, matrices: bool = False):
    """One FrameInput of `cls` (either package's) from seeded draws: a window
    of 20 network indices around frame 7."""
    shape = (3, V) if matrices else (V,)
    return cls(frame_index=7, vector_length=V, a_sample=rng.randn(*shape),
               b_sample=rng.randn(*shape), combined_sample=rng.randn(*shape),
               network_index=2, index_window=rng.randint(0, 4, 20), index_window_start=0)


def both_frame_inputs(seed: int, matrices: bool = False):
    return (frame_input(JaxFrameInput, np.random.RandomState(seed), matrices),
            frame_input(FrameInput, np.random.RandomState(seed), matrices))


@pytest.mark.parametrize("waterfall", [None, "vectors", "matrices"])
def test_synthesis_visualizer_matches_jax(waterfall):
    rng = np.random.RandomState(1)
    labels = {}
    if waterfall == "vectors":
        data = rng.randn(12 * V)
    elif waterfall == "matrices":
        data = rng.randn(3, 12 * V)
    for name, types in (("jax", jax_types), ("port", port_types)):
        labels[name] = (None if waterfall is None
                        else types.VectorsLabel(data=data, vector_length=V, label="combined"))
    jax_input, port_input = both_frame_inputs(2, matrices=waterfall == "matrices")
    want = jax_panels.synthesis_visualizer(SIDE, waterfall_vectors=labels["jax"])(jax_input)
    got = panels.synthesis_visualizer(SIDE, waterfall_vectors=labels["port"])(port_input)
    assert got.shape == (SIDE, SIDE, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("matrix", [False, True])
def test_vector_visualizer_matches_jax(matrix):
    data = np.random.RandomState(3).randn(*((4, V) if matrix else (V,)))
    kwargs = dict(y_range=(-3.0, 3.0), title="t", output_width=SIDE, output_height=64)
    got = panels.vector_visualizer(**kwargs)(data)
    assert got.shape == (64, SIDE, 3)
    np.testing.assert_array_equal(got, jax_panels.vector_visualizer(**kwargs)(data))


def test_vectors_to_video_frames_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    data = np.random.RandomState(4).randn(5 * V).astype(np.float32)
    panels.vectors_to_video(data, V, tmp_path / "port.avi", video_fps=10.0, side_length=64)
    jax_panels.vectors_to_video(data, V, tmp_path / "jax.avi", video_fps=10.0, side_length=64)
    got, want = read_avi(tmp_path / "port.avi")[0], read_avi(tmp_path / "jax.avi")[0]
    assert got.shape == (5, 64, 64, 3)
    np.testing.assert_array_equal(got, want)


def result_layers(types, rng: np.random.RandomState, length: int = 14):
    result = rng.randn(length)
    result[:2] = np.nan  # a rolling sum's warm-up
    return types.ResultLayers(
        result=types.DataLabel(result, "mask"),
        layers=[types.DataLabel(rng.randn(length), "layer a"),
                types.DataLabel(rng.randn(length), "layer b")])


@pytest.mark.parametrize("line", [None, 0.25])
def test_visualize_result_layers_matches_jax(line):
    kwargs = dict(frames_per_context=5, video_height=64, title="Overlay binary mask",
                  horizontal_line=line)
    got = list(reduction_viz.visualize_result_layers(
        result_layers(port_types, np.random.RandomState(5)), **kwargs))
    want = list(jax_reduction_viz.visualize_result_layers(
        result_layers(jax_types, np.random.RandomState(5)), **kwargs))
    assert len(got) == 14 and got[0].shape == (64, 64, 3)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def overlay_contexts(cls):
    """Written and refused frames, with each distance missing somewhere."""
    rng = np.random.RandomState(6)
    out = []
    for i in range(9):
        out.append(cls(overlay_written=bool(i % 3 == 0),
                       bbox_distance=None if i in (1, 4) else float(rng.uniform(0, 80)),
                       bbox_perceptual_hash_distance=None if i in (1, 7) else int(rng.randint(64))))
    return out


@pytest.mark.parametrize("thresholds", [False, True])
def test_visualize_overlay_computation_matches_jax(thresholds):
    def run(module, contexts):
        lines = module.VisualizeOverlayThresholds(30, 50.0) if thresholds else None
        return np.stack(list(module.visualize_overlay_computation(
            iter(contexts), frames_per_context=4, video_square_side_length=64,
            horizontal_lines=lines)))

    got = run(overlay_viz, overlay_contexts(OverlayContext))
    assert got.shape == (9, 64, 64, 3)
    np.testing.assert_array_equal(got, run(jax_overlay_viz, overlay_contexts(JaxOverlayContext)))
    # the cursor's colour follows the decision: frame 0 (written) drawn
    # again as refused differs
    flipped = overlay_contexts(OverlayContext)
    flipped[0] = flipped[0]._replace(overlay_written=False)
    assert not np.array_equal(run(overlay_viz, flipped)[0], got[0])


def test_reshape_vectors_for_3d_plotting_matches_jax():
    data = np.random.RandomState(7).randn(6 * V)
    for got, want in zip(vectors_3d.reshape_vectors_for_3d_plotting(data, V),
                         jax_vectors_3d.reshape_vectors_for_3d_plotting(data, V)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("current_index", [None, 3])
def test_plot_vectors_3d_matches_jax(current_index):
    data = np.random.RandomState(8).randn(6 * V)
    got = vectors_3d.plot_vectors_3d(port_types.VectorsLabel(data, V, "w"), current_index, 80)
    want = jax_vectors_3d.plot_vectors_3d(jax_types.VectorsLabel(data, V, "w"), current_index, 80)
    assert got.shape == (80, 80, 3)
    np.testing.assert_array_equal(got, want)


def test_multi_plot_vectors_matches_jax():
    rng = np.random.RandomState(9)
    data = [rng.randn(4 * V), rng.randn(5 * V)]
    got = vectors_3d.multi_plot_vectors(
        [port_types.VectorsLabel(d, V, f"w{i}") for i, d in enumerate(data)], side_length=64)
    want = jax_vectors_3d.multi_plot_vectors(
        [jax_types.VectorsLabel(d, V, f"w{i}") for i, d in enumerate(data)], side_length=64)
    assert got.shape == (64, 128, 3)
    np.testing.assert_array_equal(got, want)


def test_visualize_data_with_spectrogram_and_3d_vectors_matches_jax():
    """A square-wave sweep, whose spectrogram is exact in float32 on both sides."""
    from gance_tpu_torch.audio.primitives import square_wave_sweep_vertical

    data = square_wave_sweep_vertical(vector_length=V, rising_edge_x=0, pulse_width=10,
                                      y_offset=0, y_amplitude=5)
    got = vectors_3d.visualize_data_with_spectrogram_and_3d_vectors(
        port_types.VectorsLabel(data, V, "sweep"), side_length=64, device="cpu")
    want = jax_vectors_3d.visualize_data_with_spectrogram_and_3d_vectors(
        jax_types.VectorsLabel(data, V, "sweep"), side_length=64)
    assert got.shape == (64, 192, 3)
    np.testing.assert_array_equal(got, want)


def jax_reducer_for_the_port(**kwargs):
    """JAX's gzip reducer, its output in the port's types: the port's panel
    fed JAX's own signal."""
    del kwargs["device"]
    out = jax_reduction.reduce_vector_gzip_compression_rolling_average(**kwargs)
    return port_types.ResultLayers(
        result=port_types.DataLabel(np.asarray(out.result.data), out.result.label),
        layers=[port_types.DataLabel(np.asarray(x.data), x.label) for x in out.layers])


@pytest.mark.parametrize("reducer", ["jax's", "the port's"])
def test_visualize_reducer_output_matches_jax(tmp_path, reducer):
    """JAX's own test of this function reads an absent reference asset; here
    both read a fabricated WAV. Fed JAX's reducer the port's panel and PNG
    equal JAX's pixel for pixel. The port's own reducer smooths in float64
    where JAX's smooths in float32 (its layers lie up to 7.3e-4 from JAX's,
    at values near 3.7e3), which moves the anti-aliased lines: measured, 319
    of 3e6 values differ, by at most 2 steps."""
    from PIL import Image

    wav = fabricate_percussive_wav(tmp_path / "song.wav", seconds=2.0)
    port_reducer = (jax_reducer_for_the_port if reducer == "jax's"
                    else port_reduction.reduce_vector_gzip_compression_rolling_average)
    got = reduction_viz.visualize_reducer_output(
        wav, port_reducer, output_image_path=tmp_path / "port.png", num_networks=8,
        device="cpu")
    want = jax_reduction_viz.visualize_reducer_output(
        wav, jax_reduction.reduce_vector_gzip_compression_rolling_average,
        output_image_path=tmp_path / "jax.png", num_networks=8)
    assert got.shape == (1000, 1000, 3)
    got_png = np.asarray(Image.open(tmp_path / "port.png"))
    want_png = np.asarray(Image.open(tmp_path / "jax.png"))
    if reducer == "jax's":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_png, want_png)
        return
    for a, b in ((got, want), (got_png, want_png)):
        steps = np.abs(a.astype(int) - b.astype(int))
        assert int(steps.max()) <= 2 and float(np.mean(steps == 0)) >= 0.999
