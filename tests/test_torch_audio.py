"""
The port's audio layer (gance_tpu_torch.audio) and synthesis inputs against
gance_tpu's, on the CPU, with the same numpy inputs and WAVs made by
`fabricate_percussive_wav`.

Tolerances are JAX's own against scipy (tests/test_audio_dsp.py):
fourier_resample rtol 1e-4 / atol 1e-5, savgol_smooth 1e-4, minmax_scale
1e-5, rolling_mean 1e-5 with NaNs in the same places; the spectrogram chain
1e-4 absolute with non-finite entries in the same places; network indices
equal, with JAX's scaled RMS held at least 1e-4 from a half-integer so that
float32 rounding cannot flip one.

One departure: the port computes the spectrogram's FFT stage in float64
(gance_tpu_torch/audio/spectrogram.py). On the percussive track the
narrowband windows put the spectrogram's minimum at the rounding noise of
JAX's float32 FFT, so JAX's scaled spectrogram lies far from a float64 numpy
derivation of the same algorithm. There the port is held to the float64
derivation at FLOAT64_DERIVATION_TOLERANCE and to JAX at JAX_FLOAT32_FLOOR;
on broadband audio, to JAX at 1e-4.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import scipy.signal  # noqa: E402

from gance_tpu.audio import dsp as jax_dsp  # noqa: E402
from gance_tpu.audio import reduction as jax_reduction  # noqa: E402
from gance_tpu.audio import spectrogram as jax_spectrogram  # noqa: E402
from gance_tpu.audio import vectors as jax_vectors  # noqa: E402
from gance_tpu.synthesis import inputs as jax_inputs  # noqa: E402
from gance_tpu.synthesis import orchestration as jax_orchestration  # noqa: E402
from gance_tpu.types import MatricesLabel as JaxMatricesLabel  # noqa: E402
from gance_tpu_torch.audio import dsp  # noqa: E402
from gance_tpu_torch.audio import reduction, spectrogram, vectors  # noqa: E402
from gance_tpu_torch.audio.io import (  # noqa: E402
    fabricate_percussive_wav,
    read_wav_file,
    read_wavs_scale_for_video,
)
from gance_tpu_torch.synthesis import inputs, orchestration  # noqa: E402
from gance_tpu_torch.types import MatricesLabel  # noqa: E402

CPU = "cpu"
VECTOR_LENGTH = 512
# tools/spectrogram_float32_floor.py on the CPU reads the port's noise-blend
# inputs 1.03e-2 to 3.74e-2 max abs from JAX's on the percussive track (1, 2
# and 4 s, roll off and on), and the port's spectrogram at most 6.9e-7 from
# the float64 derivation.
JAX_FLOAT32_FLOOR = 5e-2
FLOAT64_DERIVATION_TOLERANCE = 1e-5


def np_(tensor) -> np.ndarray:
    return tensor.numpy()


@pytest.fixture(scope="module")
def percussive_audio(tmp_path_factory):
    """The percussive track (2 s, 44.1 kHz int16) scaled for 30 fps at 512."""
    wav = fabricate_percussive_wav(tmp_path_factory.mktemp("wav") / "song.wav", seconds=2.0)
    return read_wavs_scale_for_video([wav], VECTOR_LENGTH, frames_per_second=30.0).wav_data


@pytest.fixture(scope="module")
def broadband_audio():
    """Seeded noise at the same length: every FFT bin well above float32 noise."""
    return (np.random.RandomState(7).randn(60 * VECTOR_LENGTH) * 0.3).astype(np.float32)


def spectrogram_float64(audio: np.ndarray, vector_length: int, amplitude_range) -> np.ndarray:
    """compute_spectrogram_smooth_scale derived literally in float64 numpy/scipy."""
    x = audio.astype(np.float64)
    m = vector_length - 2
    count = (len(x) - m) // vector_length + 1
    slices = np.stack([x[k * vector_length:k * vector_length + m] for k in range(count)])
    s = np.abs(np.fft.fft(slices * np.hanning(m + 1)[:-1], axis=1).T[: m // 2])
    db = 20 * np.log10(s / s.max())
    flat = scipy.signal.resample(db.T, vector_length, axis=-1).reshape(-1)
    lo, hi = amplitude_range
    flat = (flat - flat.min()) / (flat.max() - flat.min()) * (hi - lo) + lo
    divided = scipy.signal.savgol_filter(flat.reshape(-1, vector_length), 7, 3, axis=0)
    return scipy.signal.savgol_filter(divided, 5, 3, axis=1).reshape(-1)


def assert_same_nonfinite_and_close(got: np.ndarray, want: np.ndarray, atol: float) -> None:
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if finite.any():
        assert float(np.abs(got[finite] - want[finite]).max()) <= atol


# ------------------------------------------------------------------- dsp


@pytest.mark.parametrize("n,num", [(255, 512), (512, 255), (100, 100), (33, 64), (64, 33),
                                   (64, 32), (32, 64), (63, 31), (31, 63)])
def test_fourier_resample_matches_jax(rng, n, num):
    """Smaller and larger, odd and even: the Nyquist fix applies only when
    m = min(n, num) is even and num != n."""
    x = rng.randn(4, n).astype(np.float32)
    got = np_(dsp.fourier_resample(x, num, axis=-1, device=CPU))
    np.testing.assert_allclose(got, np.asarray(jax_dsp.fourier_resample(x, num, axis=-1)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, scipy.signal.resample(x, num, axis=-1), rtol=1e-4, atol=1e-5)


def test_fourier_resample_axis0_and_float64_input(rng):
    x = rng.randn(40, 6)  # float64: both compute in float32
    got = np_(dsp.fourier_resample(x, 25, axis=0, device=CPU))
    assert got.dtype == np.float32 and got.shape == (25, 6)
    np.testing.assert_allclose(got, np.asarray(jax_dsp.fourier_resample(x, 25, axis=0)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("w,p,n", [(7, 3, 50), (5, 3, 20), (3, 2, 9), (7, 3, 7), (51, 2, 512)])
def test_savgol_smooth_matches_jax(rng, w, p, n):
    x = rng.randn(3, n).astype(np.float32)
    got = np_(dsp.savgol_smooth(x, w, p, axis=-1, device=CPU))
    np.testing.assert_allclose(got, np.asarray(jax_dsp.savgol_smooth(x, w, p, axis=-1)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, scipy.signal.savgol_filter(x, w, p, axis=-1),
                               rtol=1e-4, atol=1e-4)


def test_savgol_smooth_axis0_float64_and_short_signal(rng):
    x = rng.randn(20, 6)
    got = np_(dsp.savgol_smooth(x, 7, 3, axis=0, device=CPU))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_dsp.savgol_smooth(x, 7, 3, axis=0)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="window_length"):
        jax_dsp.savgol_smooth(x[:6], 7, 3, axis=0)
    with pytest.raises(ValueError, match="window_length"):
        dsp.savgol_smooth(x[:6], 7, 3, axis=0, device=CPU)


@pytest.mark.parametrize("case", ["random", "constant", "nan"])
def test_minmax_scale_matches_jax(rng, case):
    x = {"random": rng.randn(100), "constant": np.full((10,), 3.0),
         "nan": np.array([0.5, np.nan, -2.0, 1.0])}[case]
    got = np_(dsp.minmax_scale(x, feature_range=(-4.0, 4.0), device=CPU))
    want = np.asarray(jax_dsp.minmax_scale(x, feature_range=(-4.0, 4.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    if case == "nan":
        assert np.isnan(got).all()


@pytest.mark.parametrize("n,window", [(50, 3), (7, 7), (2, 3)])
def test_rolling_mean_matches_jax(rng, n, window):
    """A series shorter than the window is all NaN."""
    x = rng.randn(n)
    got = np_(dsp.rolling_mean(x, window, device=CPU))
    want = np.asarray(jax_dsp.rolling_mean(x, window))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    if n >= window:
        assert int(np.isnan(got).sum()) == window - 1
    else:
        assert np.isnan(got).all()


@pytest.mark.parametrize("frame_length,center", [(1024, False), (512, False), (1000, False),
                                                 (1024, True)])
def test_rms_frames_matches_jax(rng, frame_length, center):
    """librosa's hop of 512 whatever the frame length."""
    x = rng.randn(4096).astype(np.float32)
    got = np_(dsp.rms_frames(x, frame_length=frame_length, center=center, device=CPU))
    want = np.asarray(jax_dsp.rms_frames(x, frame_length=frame_length, center=center))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert dsp.rms_frames(x[:100], frame_length=512, device=CPU).shape == (0,)


@pytest.mark.parametrize("n,m", [(5, 5), (7, 4), (4, 9)])
def test_rotate_vectors_over_time_truncates_like_jax(rng, n, m):
    data = rng.randn(n, 8).astype(np.float32)
    rolls = rng.randint(0, 4, size=m)
    got = np_(dsp.rotate_vectors_over_time(data, rolls, device=CPU))
    want = np.asarray(jax_dsp.rotate_vectors_over_time(data, rolls))
    assert got.shape == (min(n, m), 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [1, 2, 3, 4, 7, 45])
def test_maximum_filter1d_matches_jax(rng, size):
    import scipy.ndimage

    x = rng.randn(40).astype(np.float32)
    got = np_(dsp.maximum_filter1d(x, size=size, device=CPU))
    np.testing.assert_array_equal(got, np.asarray(jax_dsp.maximum_filter1d(x, size=size)))
    np.testing.assert_array_equal(got, scipy.ndimage.maximum_filter1d(x, size=size))


@pytest.mark.parametrize("input_range", [None, (2.0, 2.0)])
def test_remap_values_into_range_matches_jax(rng, input_range):
    x = rng.randn(300) * 3
    input_range = input_range or (float(x.min()), float(x.max()))
    got = np_(dsp.remap_values_into_range(x, input_range, (0.0, 2.0), device=CPU))
    want = np.asarray(jax_dsp.remap_values_into_range(x, input_range, (0.0, 2.0)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dsp_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        dsp.minmax_scale(np.zeros(3))


# ----------------------------------------------------------- spectrogram


@pytest.mark.parametrize("truncate", [True, False])
def test_compute_spectrogram_matches_jax_on_broadband_audio(broadband_audio, truncate):
    got = np_(spectrogram.compute_spectrogram(broadband_audio, 64, truncate=truncate, device=CPU))
    want = np.asarray(jax_spectrogram.compute_spectrogram(broadband_audio, 64, truncate=truncate))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)  # JAX's test against numpy


def test_spectrogram_smooth_scale_matches_jax_on_broadband_audio(broadband_audio):
    got = np_(spectrogram.compute_spectrogram_smooth_scale(
        broadband_audio, VECTOR_LENGTH, amplitude_range=(-1.0, 1.0), device=CPU))
    want = np.asarray(jax_spectrogram.compute_spectrogram_smooth_scale(
        broadband_audio, VECTOR_LENGTH, amplitude_range=(-1.0, 1.0)))
    assert_same_nonfinite_and_close(got, want, 1e-4)


def test_spectrogram_smooth_scale_on_percussive_audio(percussive_audio):
    """The float32 floor departure (module docstring), measured."""
    got = np_(spectrogram.compute_spectrogram_smooth_scale(
        percussive_audio, VECTOR_LENGTH, amplitude_range=(-1.0, 1.0), device=CPU))
    want = np.asarray(jax_spectrogram.compute_spectrogram_smooth_scale(
        percussive_audio, VECTOR_LENGTH, amplitude_range=(-1.0, 1.0)))
    exact = spectrogram_float64(percussive_audio, VECTOR_LENGTH, (-1.0, 1.0))
    assert float(np.abs(got - exact).max()) <= FLOAT64_DERIVATION_TOLERANCE
    assert_same_nonfinite_and_close(got, want, JAX_FLOAT32_FLOOR)


def test_spectrogram_of_digital_silence_is_nan_where_jax_is(broadband_audio):
    """A silent window gives -inf dB, and NaN after the resample and scaling."""
    audio = broadband_audio.copy()
    audio[5 * VECTOR_LENGTH:6 * VECTOR_LENGTH] = 0.0
    raw = np_(spectrogram.compute_spectrogram(audio, VECTOR_LENGTH, device=CPU))
    raw_want = np.asarray(jax_spectrogram.compute_spectrogram(audio, VECTOR_LENGTH))
    assert np.isneginf(raw[:, 5]).all()
    assert_same_nonfinite_and_close(raw, raw_want, 1e-2)
    got = np_(spectrogram.compute_spectrogram_smooth_scale(
        audio, VECTOR_LENGTH, amplitude_range=(-1.0, 1.0), device=CPU))
    want = np.asarray(jax_spectrogram.compute_spectrogram_smooth_scale(
        audio, VECTOR_LENGTH, amplitude_range=(-1.0, 1.0)))
    assert np.isnan(want).any()
    assert_same_nonfinite_and_close(got, want, 1e-4)


# -------------------------------------------------------------- reducers


def assert_clear_of_half_integers(results_layers, network_count: int) -> None:
    data = np.asarray(results_layers.result.data, np.float64)
    scaled = np.asarray(jax_dsp.remap_values_into_range(
        data, (float(data.min()), float(data.max())), (0.0, float(network_count - 1))))
    margin = float(np.min(np.abs(scaled - np.floor(scaled) - 0.5)))
    assert margin > 1e-4, f"a scaled RMS value lies {margin:.2g} from a half-integer"


@pytest.mark.parametrize("network_count", [2, 3])
def test_rms_reduction_and_quantization_match_jax(percussive_audio, network_count):
    got = reduction.reduce_vector_rms_rolling_average(percussive_audio, VECTOR_LENGTH, device=CPU)
    want = jax_reduction.reduce_vector_rms_rolling_average(percussive_audio, VECTOR_LENGTH)
    np.testing.assert_allclose(got.result.data, want.result.data, rtol=1e-5, atol=1e-6)
    assert [layer.label for layer in got.layers] == [layer.label for layer in want.layers]
    for g, w in zip(got.layers, want.layers):
        np.testing.assert_allclose(g.data, w.data, rtol=1e-5, atol=1e-6, equal_nan=True)
    assert_clear_of_half_integers(want, network_count)
    indices = list(range(network_count))
    q_got = reduction.quantize_results_layers(got, indices, device=CPU)
    q_want = jax_reduction.quantize_results_layers(want, indices)
    np.testing.assert_array_equal(q_got.result.data, q_want.result.data)
    assert q_got.result.label == q_want.result.label
    assert set(q_got.result.data.tolist()) == set(indices)


def test_rms_rolling_max_and_projection_smoothing_match_jax(percussive_audio):
    got = reduction.reduce_vector_rms_rolling_max(percussive_audio, 64, device=CPU)
    want = jax_reduction.reduce_vector_rms_rolling_max(percussive_audio, 64)
    np.testing.assert_allclose(got.result.data, want.result.data, rtol=1e-5, atol=1e-7)
    got = reduction.reduce_vector_rms_rolling_average(
        percussive_audio, VECTOR_LENGTH, savgol_window_length=3, savgol_polyorder=2, device=CPU)
    want = jax_reduction.reduce_vector_rms_rolling_average(
        percussive_audio, VECTOR_LENGTH, savgol_window_length=3, savgol_polyorder=2)
    np.testing.assert_allclose(got.result.data, want.result.data, rtol=1e-5, atol=1e-6)


def test_vectors_helpers_match_jax(rng):
    data = rng.randn(20 * 16)
    for name, kwargs in (("smooth_across_vectors", {}), ("smooth_each_vector",
                                                        {"window_length": 5, "polyorder": 3})):
        got = getattr(vectors, name)(data, 16, device=CPU, **kwargs)
        np.testing.assert_allclose(got, getattr(jax_vectors, name)(data, 16, **kwargs),
                                   rtol=1e-4, atol=1e-4)
    got = vectors.scale_vectors_to_length_resample(data, 16, 24, device=CPU)
    np.testing.assert_allclose(got, jax_vectors.scale_vectors_to_length_resample(data, 16, 24),
                               rtol=1e-4, atol=1e-5)
    matrices = rng.randn(3, 6 * 16).astype(np.float32)
    rolls = np.array([1, 0, 2, 1, 3, 2])
    np.testing.assert_array_equal(
        vectors.rotate_vectors_over_time(matrices, 16, rolls, device=CPU),
        jax_vectors.rotate_vectors_over_time(matrices, 16, rolls))
    np.testing.assert_array_equal(vectors.sub_vectors(matrices, 16),
                                  jax_vectors.sub_vectors(matrices, 16))


# ---------------------------------------------------------------- inputs


def assert_inputs_match(got, want, spectrogram_tolerance: float) -> None:
    for field in ("a_vectors", "b_vectors", "combined"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.label == w.label and g.vector_length == w.vector_length
        atol = 1e-4 if field == "b_vectors" else spectrogram_tolerance
        assert_same_nonfinite_and_close(np.asarray(g.data), np.asarray(w.data), atol)
    np.testing.assert_array_equal(got.network_indices.result.data,
                                  want.network_indices.result.data)
    assert got.network_indices.result.label == want.network_indices.result.label
    assert [x.label for x in got.network_indices.layers] == [
        x.label for x in want.network_indices.layers]


def spectrogram_input_float64(audio: np.ndarray, roll: bool) -> np.ndarray:
    """The float64 derivation of the noise blend's spectrogram vectors, rolled
    and re-smoothed by gance_tpu when `roll`."""
    exact = spectrogram_float64(audio, VECTOR_LENGTH, (-1.0, 1.0))
    if roll:
        rolls = jax_reduction.quantize_results_layers(
            jax_reduction.reduce_vector_rms_rolling_average(audio, VECTOR_LENGTH), [0, 1, 2])
        exact = np.asarray(jax_vectors.smooth_each_vector(jax_vectors.rotate_vectors_over_time(
            exact, VECTOR_LENGTH, rolls.result.data), VECTOR_LENGTH))
    return exact


@pytest.mark.parametrize("roll", [False, True])
def test_alpha_blend_vectors_matches_jax(percussive_audio, broadband_audio, roll):
    for audio, broadband in ((broadband_audio, True), (percussive_audio, False)):
        got = inputs.alpha_blend_vectors_max_rms_power_audio(
            0.25, roll, (-1.0, 1.0), audio, VECTOR_LENGTH, [0, 1], device=CPU)
        want = jax_inputs.alpha_blend_vectors_max_rms_power_audio(
            0.25, roll, (-1.0, 1.0), audio, VECTOR_LENGTH, [0, 1])
        if broadband:
            assert_inputs_match(got, want, 1e-4)
            continue
        assert_clear_of_half_integers(
            jax_reduction.reduce_vector_rms_rolling_average(audio, VECTOR_LENGTH), 2)
        assert_same_nonfinite_and_close(np.asarray(got.a_vectors.data),
                                        spectrogram_input_float64(audio, roll),
                                        FLOAT64_DERIVATION_TOLERANCE)
        assert_inputs_match(got, want, JAX_FLOAT32_FLOOR)


@pytest.fixture(scope="module")
def projection_blends(percussive_audio):
    """Both packages' projection blends: 8 rows, blend depth 4, final latents
    at half the frame rate (each duplicated twice)."""
    frames = len(percussive_audio) // VECTOR_LENGTH
    rows = np.random.RandomState(3).randn(1, frames // 2 * VECTOR_LENGTH).astype(np.float32)
    latents = np.repeat(rows, 8, axis=0)
    args = (0.25, False, (-1.0, 1.0), 4, percussive_audio, VECTOR_LENGTH, [0, 1, 2])
    got = inputs.alpha_blend_projection_file(MatricesLabel(latents, VECTOR_LENGTH, "final"), *args,
                                             device=CPU)
    want = jax_inputs.alpha_blend_projection_file(
        JaxMatricesLabel(latents, VECTOR_LENGTH, "final"), *args)
    return got, want


def test_alpha_blend_projection_file_matches_jax(projection_blends, percussive_audio):
    got, want = projection_blends
    assert got.combined.data.shape == want.combined.data.shape == (8, len(percussive_audio))
    assert_inputs_match(got, want, JAX_FLOAT32_FLOOR)
    np.testing.assert_array_equal(got.combined.data[4:], want.combined.data[4:])


def test_slice_visualization_input_and_frame_inputs_match_jax(projection_blends):
    got, want = projection_blends
    got_tail = inputs.slice_visualization_input(got, 5)
    want_tail = jax_inputs.slice_visualization_input(want, 5)
    assert inputs.slice_visualization_input(got, 0) is got
    for field in ("a_vectors", "b_vectors", "combined"):
        assert getattr(got_tail, field).data.shape == getattr(want_tail, field).data.shape
        np.testing.assert_array_equal(getattr(got_tail, field).data,
                                      getattr(got, field).data[..., 5 * VECTOR_LENGTH:])
    np.testing.assert_array_equal(got_tail.network_indices.result.data,
                                  want_tail.network_indices.result.data)
    got_frames = orchestration.frame_inputs(got_tail, frames_to_visualize=7,
                                            network_index_window_width=4)
    want_frames = jax_orchestration.frame_inputs(want_tail, frames_to_visualize=7,
                                                 network_index_window_width=4)
    assert len(got_frames) == len(want_frames) == 7
    for g, w in zip(got_frames, want_frames):
        assert (g.frame_index, g.network_index, g.index_window_start) == (
            w.frame_index, w.network_index, w.index_window_start)
        np.testing.assert_array_equal(g.index_window, w.index_window)
        assert g.combined_sample.shape == w.combined_sample.shape == (8, VECTOR_LENGTH)


def test_wav_io_copy_reads_what_jax_reads(tmp_path):
    from gance_tpu.audio.io import read_wav_file as jax_read_wav_file

    wav = fabricate_percussive_wav(tmp_path / "clip.wav", seconds=0.5, dtype="float32")
    got, want = read_wav_file(wav), jax_read_wav_file(wav)
    assert got.sample_rate == want.sample_rate == 44100 and got.name == want.name
    np.testing.assert_array_equal(got.wav_data, want.wav_data)
    scaled = read_wavs_scale_for_video([wav], 64, target_num_vectors=40)
    assert scaled.wav_data.shape == (40 * 64,)
