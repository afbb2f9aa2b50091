"""
Latent vector-array algebra over the flat "concatenated" layout (a copy of
gance_tpu/audio/vectors.py over the port's torch `dsp`).

Numpy in, numpy out. The functions that smooth, resample or roll run through
`audio/dsp.py` on `device` (default "cuda"); the rest are host numpy/scipy.
"""

import numpy as np
from scipy.interpolate import interp1d

from gance_tpu_torch.audio.dsp import (  # noqa: F401 (re-exported, as gance_tpu's module does)
    fourier_resample,
    minmax_scale,
    remap_values_into_range,
    rotate_vectors_over_time as _rotate_divided,
    savgol_smooth,
)
from gance_tpu_torch.types import underlying_length  # noqa: F401 (re-exported)
from gance_tpu_torch.utils.device import Device
from gance_tpu_torch.utils.divisor import divide_no_remainder


def to_numpy(tensor) -> np.ndarray:
    """A tensor (on any device) as a host numpy array."""
    return tensor.detach().cpu().numpy()


def sub_vectors(data: np.ndarray, vector_length: int) -> np.ndarray:
    """
    Flat -> divided. Vectors (N*V,) -> (N, V); matrices (R, N*V) -> (N, R, V).
    """
    data = np.asarray(data)
    if data.ndim >= 2:
        num = data.shape[-1] // vector_length
        return np.stack(np.split(data, num, axis=-1))
    return data.reshape(-1, vector_length)


def smooth_across_vectors(
    data: np.ndarray, vector_length: int, window_length: int = 7, polyorder: int = 3,
    device: Device = "cuda",
) -> np.ndarray:
    """Savgol along time per latent dim. Flat in, flat out."""
    divided = sub_vectors(np.asarray(data), vector_length)
    return to_numpy(savgol_smooth(divided, window_length, polyorder, axis=0,
                                  device=device)).reshape(-1)


def smooth_each_vector(
    data: np.ndarray, vector_length: int, window_length: int = 51, polyorder: int = 2,
    device: Device = "cuda",
) -> np.ndarray:
    """Savgol within each sub-vector. Flat in, flat out."""
    divided = sub_vectors(np.asarray(data), vector_length)
    return to_numpy(savgol_smooth(divided, window_length, polyorder, axis=1,
                                  device=device)).reshape(-1)


def scale_vectors_to_length_resample(
    data: np.ndarray, original_vector_length: int, output_vector_length: int,
    device: Device = "cuda",
) -> np.ndarray:
    """Fourier-resample each sub-vector to a new length."""
    divided = sub_vectors(np.asarray(data), original_vector_length)
    return to_numpy(fourier_resample(divided, output_vector_length, axis=-1,
                                     device=device)).reshape(-1)


def scale_vectors_to_length_linspace(
    data: np.ndarray, original_vector_length: int, output_vector_length: int
) -> np.ndarray:
    """Cubic-interp1d per-vector rescale."""
    divided = sub_vectors(np.asarray(data), original_vector_length)
    xs = np.arange(original_vector_length)
    new_xs = np.linspace(0, original_vector_length - 1, num=output_vector_length)
    out = interp1d(xs, divided, kind="cubic", axis=1)(new_xs)
    return out.reshape(-1)


def interpolate_to_vector_count(
    data: np.ndarray, vector_length: int, target_vector_count: int
) -> np.ndarray:
    """Linear interpolation along time to a new vector count."""
    divided = sub_vectors(np.asarray(data), vector_length)  # (N, V)
    xs = np.arange(divided.shape[0])
    new_xs = np.linspace(0, xs.max(), num=target_vector_count)
    out = interp1d(xs, divided, axis=0)(new_xs)
    return out.reshape(-1)


def duplicate_to_vector_count(
    data: np.ndarray, vector_length: int, target_vector_count: int
) -> np.ndarray:
    """
    Repeat each sub-vector an integral number of times (raises ValueError if the
    duplication factor isn't whole: the fps/projection-fps contract).
    """
    divided = sub_vectors(np.asarray(data), vector_length)
    original_count = divided.shape[0]
    try:
        factor = divide_no_remainder(target_vector_count, original_count)
    except ValueError as e:
        raise ValueError(
            f"Cannot duplicate the input vectors (count {original_count}) "
            f"to the desired count {target_vector_count}."
        ) from e
    return np.repeat(divided, factor, axis=0).reshape(-1)


def promote_to_matrix_duplicate(data: np.ndarray, target_depth: int) -> np.ndarray:
    """Tile a flat vector array to matrix depth: (L,) -> (target_depth, L)."""
    data = np.asarray(data)
    if data.ndim != 1:
        raise ValueError("Undefined behavior!")
    return np.tile(data, (target_depth, 1))


def demote_to_vector_select(data: np.ndarray, index_to_take: int = 0) -> np.ndarray:
    """Select one row of a matrix array."""
    return np.asarray(data)[index_to_take]


def rotate_vectors_over_time(
    data: np.ndarray, vector_length: int, roll_values: np.ndarray, device: Device = "cuda"
) -> np.ndarray:
    """
    FFT-roll over flat vectors OR flat matrices. The roll of each time step is
    the cumulative sum of roll_values (negated, matching np.roll(v, -r)).
    """
    data = np.asarray(data)
    roll_values = np.asarray(roll_values)
    if data.ndim >= 2:
        # matrices (R, N*V): roll each row's sub-vectors identically
        return np.stack([
            to_numpy(_rotate_divided(row.reshape(-1, vector_length), roll_values,
                                     device=device)).reshape(-1)
            for row in data
        ])
    divided = data.reshape(-1, vector_length)
    return to_numpy(_rotate_divided(divided, roll_values, device=device)).reshape(-1)


def interpolate_between_vectors(
    start: np.ndarray, end: np.ndarray, count: int
) -> np.ndarray:
    """Linear transition between two vectors, flattened."""
    ts = np.linspace(0.0, 1.0, num=count)[:, None]
    out = np.asarray(start)[None, :] * (1 - ts) + np.asarray(end)[None, :] * ts
    return out.reshape(-1)
