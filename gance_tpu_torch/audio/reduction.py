"""
Audio -> scalar-per-frame reducers that drive network selection and overlay
gating (a copy of gance_tpu/audio/reduction.py over the port's torch `dsp`).

The RMS, rolling and smoothing math runs through `audio/dsp.py` on `device`
(default "cuda"); the results come back as numpy `DataLabel`s. Two reducers
stay on the host by nature: gzip complexity (zlib byte counts) and the
smoothing-spline derivative (scipy UnivariateSpline). Dtypes follow JAX,
which runs without x64: the signals are float32 on the device and float64
on the host between the steps.
"""

import zlib
from typing import List

import numpy as np
from scipy.interpolate import UnivariateSpline

from gance_tpu_torch.audio.dsp import (
    maximum_filter1d,
    remap_values_into_range,
    rms_frames,
    rolling_mean,
    savgol_smooth,
)
from gance_tpu_torch.audio.vectors import sub_vectors, to_numpy
from gance_tpu_torch.types import DataLabel, ResultLayers
from gance_tpu_torch.utils.device import Device


def _compute_raw_rms(
    time_series_audio_vectors: np.ndarray, vector_length: int, device: Device
) -> np.ndarray:
    """One RMS value per frame's worth of audio (librosa.feature.rms semantics)."""
    return to_numpy(rms_frames(np.asarray(time_series_audio_vectors),
                               frame_length=vector_length, device=device))


def reduce_vector_rms_rolling_max(
    time_series_audio_vectors: np.ndarray, vector_length: int, device: Device = "cuda"
) -> ResultLayers:
    """RMS -> rolling max over a len/80 window."""
    raw_rms = _compute_raw_rms(time_series_audio_vectors, vector_length, device)
    feature_length = int(len(raw_rms) / 80)
    output = (
        to_numpy(maximum_filter1d(raw_rms, size=feature_length, device=device))
        if feature_length > 0
        else raw_rms
    )
    return ResultLayers(
        result=DataLabel(output, "Rolling Max"),
        layers=[DataLabel(raw_rms, "Raw RMS Power")],
    )


def _smoothed_rolling_average(
    input_values: DataLabel,
    rolling_average_window: int = 3,
    savgol_window_length: int = 7,
    savgol_polyorder: int = 3,
    device: Device = "cuda",
) -> ResultLayers:
    """Rolling mean (NaNs filled with the global mean) then savgol."""
    data = np.asarray(input_values.data, dtype=np.float64)
    rolled = to_numpy(rolling_mean(data, rolling_average_window, device=device)).astype(np.float64)
    rolled = np.where(np.isnan(rolled), data.mean(), rolled)
    smoothed = to_numpy(
        savgol_smooth(rolled, savgol_window_length, savgol_polyorder, device=device)
    )
    return ResultLayers(
        result=DataLabel(
            smoothed,
            "Savgol Smoothing Filter "
            f"(window={savgol_window_length}, polyorder={savgol_polyorder})",
        ),
        layers=[
            DataLabel(rolled, f"Rolling Average (window={rolling_average_window})"),
            input_values,
        ],
    )


def reduce_vector_rms_rolling_average(
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    rolling_average_window: int = 3,
    savgol_window_length: int = 7,
    savgol_polyorder: int = 3,
    device: Device = "cuda",
) -> ResultLayers:
    """RMS -> rolling average -> savgol."""
    return _smoothed_rolling_average(
        DataLabel(
            _compute_raw_rms(time_series_audio_vectors, vector_length, device),
            "Raw RMS Power",
        ),
        rolling_average_window=rolling_average_window,
        savgol_window_length=savgol_window_length,
        savgol_polyorder=savgol_polyorder,
        device=device,
    )


def reduce_vector_gzip_compression_rolling_average(
    time_series_audio_vectors: np.ndarray, vector_length: int, device: Device = "cuda"
) -> ResultLayers:
    """
    Per-frame zlib-compressed byte length as a "musical complexity" proxy
    (host-side by nature: DEFLATE on raw bytes), then the rolling average.
    """
    divided = sub_vectors(np.asarray(time_series_audio_vectors), vector_length)
    compressed_sizes = np.array(
        [len(zlib.compress(vector.tobytes())) for vector in divided]
    )
    return _smoothed_rolling_average(DataLabel(compressed_sizes, "Gzipped Audio"),
                                     device=device)


def quantize_results_layers(
    results_layers: ResultLayers, network_indices: List[int], device: Device = "cuda"
) -> ResultLayers:
    """
    Scale the reducer output into [0, n_networks-1] and round to ints: the
    per-frame network selector.
    """
    data = np.asarray(results_layers.result.data, dtype=np.float64)
    scaled = to_numpy(
        remap_values_into_range(
            data,
            input_range=(float(data.min()), float(data.max())),
            output_range=(0.0, float(len(network_indices) - 1)),
            device=device,
        )
    )
    quantized = np.rint(scaled).astype(int)
    return ResultLayers(
        result=DataLabel(quantized, f"{results_layers.result.label} Scaled, Quantized"),
        layers=[results_layers.result] + results_layers.layers,
    )


def _derive_data(data: np.ndarray, order: int) -> np.ndarray:
    """Smoothing-spline derivative, NaNs zeroed first."""
    data = np.nan_to_num(np.asarray(data, dtype=np.float64))
    x_axis = np.arange(len(data))
    return UnivariateSpline(x=x_axis, y=data).derivative(n=order)(x_axis)


def derive_results_layers(results_layers: ResultLayers, order: int) -> ResultLayers:
    """nth-order derivative of the result signal."""
    return ResultLayers(
        result=DataLabel(
            _derive_data(results_layers.result.data, order), f"Derevation order={order}"
        ),
        layers=[results_layers.result] + results_layers.layers,
    )


def absolute_value_results_layers(results_layers: ResultLayers) -> ResultLayers:
    """|result|."""
    return ResultLayers(
        result=DataLabel(np.abs(np.asarray(results_layers.result.data)), "Absolute Value"),
        layers=[results_layers.result] + results_layers.layers,
    )


def rolling_sum_results_layers(results_layers: ResultLayers, window_length: int) -> ResultLayers:
    """Trailing rolling sum, NaN for the first window-1 entries."""
    data = np.asarray(results_layers.result.data, dtype=np.float64)
    csum = np.cumsum(data)
    sums = csum - np.concatenate([np.zeros(window_length), csum[:-window_length]])
    sums[: window_length - 1] = np.nan
    return ResultLayers(
        result=DataLabel(sums, f"Rolling Sum (window={window_length})"),
        layers=[results_layers.result] + results_layers.layers,
    )


def music_complexity_mask(
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    rolling_sum_window: int,
    device: Device = "cuda",
) -> ResultLayers:
    """
    Per-frame "how fast is the music's complexity changing" signal that gates
    the eye-tracking overlay: gzip complexity -> 1st derivative -> |.| ->
    trailing rolling sum. High values mean the music is in flux.
    """
    complexity = reduce_vector_gzip_compression_rolling_average(
        time_series_audio_vectors=time_series_audio_vectors,
        vector_length=vector_length,
        device=device,
    )
    change_rate = derive_results_layers(complexity, order=1)
    return rolling_sum_results_layers(
        absolute_value_results_layers(
            ResultLayers(
                result=DataLabel(change_rate.result.data, "Complexity change rate"),
                layers=[],
            )
        ),
        window_length=rolling_sum_window,
    )


def track_length_filter(bool_tracks: np.ndarray, track_length: int) -> np.ndarray:
    """Reject runs of True shorter than `track_length` (run-length encoding)."""
    flags = np.asarray(bool_tracks).astype(bool)
    if flags.size == 0:
        return flags
    change = np.concatenate([[True], flags[1:] != flags[:-1]])
    run_ids = np.cumsum(change) - 1
    run_lengths = np.bincount(run_ids)
    return flags & (run_lengths[run_ids] >= track_length)
