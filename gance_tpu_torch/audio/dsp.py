"""
The audio DSP primitives in torch, on the caller's device (the counterpart of
gance_tpu/audio/dsp.py, whose jitted jnp functions these follow op for op).

Each function replicates a host-library op (scipy.signal.resample /
savgol_filter, sklearn minmax_scale, pandas rolling mean, librosa RMS,
np.roll per vector, scipy.ndimage.maximum_filter1d). Every one takes its input
as a numpy array or a tensor, computes in float32 on `device` (JAX runs
without x64, so float64 inputs are rounded to float32 at the same points) and
returns a float32 tensor on `device`. `device` defaults to "cuda" and raises
on a host without CUDA.
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import savgol_coeffs
from scipy.signal import savgol_filter as _scipy_savgol

from gance_tpu_torch.ops.precision import exact_fp32
from gance_tpu_torch.utils.device import Device, resolve_device


def as_float32(x, device: Device) -> torch.Tensor:
    """`x` (array-like or tensor) as a float32 tensor on `device`."""
    device = resolve_device(device)
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def fourier_resample(x, num: int, axis: int = -1, device: Device = "cuda") -> torch.Tensor:
    """
    scipy.signal.resample (Fourier method, real input) along `axis`:
    truncate/zero-pad the rfft, fix the unpaired Nyquist bin, scaled irfft.
    """
    x = as_float32(x, device).movedim(axis, -1)
    n = x.shape[-1]
    m = min(num, n)
    spectrum = torch.fft.rfft(x)[..., : m // 2 + 1]
    if m % 2 == 0 and num != n:
        spectrum[..., m // 2] *= 2.0 if num < n else 0.5
    y = torch.fft.irfft(spectrum / (n / num), n=num)
    return y.movedim(-1, axis)


@functools.lru_cache(maxsize=None)
def _savgol_matrices(window_length: int, polyorder: int) -> Tuple[np.ndarray, np.ndarray]:
    """Interior correlation coeffs + exact edge operator (scipy mode='interp'),
    computed once on the host with scipy."""
    coeffs = savgol_coeffs(window_length, polyorder)  # symmetric for deriv=0
    edge_op = _scipy_savgol(np.eye(window_length), window_length, polyorder, axis=0)
    return coeffs.astype(np.float64), edge_op.astype(np.float64)


def savgol_smooth(
    x, window_length: int, polyorder: int, axis: int = -1, device: Device = "cuda"
) -> torch.Tensor:
    """
    Savitzky-Golay smoothing (deriv=0) matching scipy.signal.savgol_filter's
    default mode='interp': an FIR correlation with the reversed coefficients in
    the interior, and polynomial-fit edges, which scipy's exact (W, W) operator
    applies to the first and last W samples. Signals shorter than the window raise.
    """
    coeffs, edge_op = _savgol_matrices(window_length, polyorder)
    half = window_length // 2
    x = as_float32(x, device).movedim(axis, -1)
    lead_shape, n = x.shape[:-1], x.shape[-1]
    if n < window_length:
        raise ValueError(f"signal length {n} < window_length {window_length}")
    kernel = torch.from_numpy(coeffs[::-1].astype(np.float32)).to(x.device).view(1, 1, -1)
    edges = torch.from_numpy(edge_op.astype(np.float32)).to(x.device)
    with exact_fp32():
        y = F.conv1d(x.reshape(-1, 1, n), kernel, padding=half).reshape(*lead_shape, n)
        if half:
            y[..., :half] = x[..., :window_length] @ edges[:half].T
            y[..., -half:] = x[..., -window_length:] @ edges[-half:].T
    return y.movedim(-1, axis)


def minmax_scale(
    x, feature_range: Tuple[float, float] = (0.0, 1.0), device: Device = "cuda"
) -> torch.Tensor:
    """
    sklearn.preprocessing.minmax_scale over the flattened array: map [min, max]
    to feature_range; constant input maps to the low end; a NaN anywhere makes
    every output NaN, as jnp.min/max propagate it.
    """
    x = as_float32(x, device)
    lo, hi = feature_range
    xmin, xmax = x.min(), x.max()
    scale = torch.where(xmax > xmin, xmax - xmin, torch.ones_like(xmax))
    return (x - xmin) / scale * (hi - lo) + lo


def remap_values_into_range(
    data,
    input_range: Tuple[float, float],
    output_range: Tuple[float, float],
    device: Device = "cuda",
) -> torch.Tensor:
    """Linear range remap, in float32 as JAX computes it (the factor is the
    float32 quotient of the float32 spans)."""
    in0, in1 = input_range
    out0, out1 = output_range
    data = as_float32(data, device)
    span = in1 - in0
    factor = torch.tensor(out1 - out0, dtype=torch.float32) / torch.tensor(
        1.0 if span == 0 else span, dtype=torch.float32)
    return (data - in0) * factor.to(data.device) + out0


def rolling_mean(
    x, window: int, min_periods: Optional[int] = None, device: Device = "cuda"
) -> torch.Tensor:
    """
    pandas Series.rolling(window).mean(): a trailing window, NaN for the first
    window-1 positions; a series shorter than the window is all NaN.
    """
    del min_periods
    x = as_float32(x, device)
    if x.shape[0] < window:
        return torch.full_like(x, float("nan"))
    csum = torch.cumsum(x, dim=0)
    shifted = torch.cat([torch.zeros(window, dtype=x.dtype, device=x.device), csum[:-window]])
    means = (csum - shifted) / window
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(idx >= window - 1, means, torch.full_like(means, float("nan")))


def rms_frames(
    x, frame_length: int, hop_length: int = 512, center: bool = False,
    device: Device = "cuda",
) -> torch.Tensor:
    """
    librosa.feature.rms: RMS over frames of `frame_length` samples advancing by
    `hop_length` (librosa's default hop is 512 whatever the frame length).
    """
    x = as_float32(x, device)
    if center:
        pad = frame_length // 2
        x = F.pad(x.view(1, 1, -1), (pad, pad), mode="reflect").view(-1)
    if x.shape[0] < frame_length:
        return x.new_zeros((0,))
    frames = x.unfold(0, frame_length, hop_length)
    return torch.sqrt(torch.mean(frames.square(), dim=1))


def rotate_vectors_over_time(data, roll_values, device: Device = "cuda") -> torch.Tensor:
    """
    FFT-roll: circularly shift vector i by cumsum(roll_values)[i] (np.roll(v, -r)
    per vector, as one gather). When the two streams differ in length the
    output truncates to the shorter of the two.

    :param data: (N, V) divided vectors.
    :param roll_values: (M,) per-vector roll increments.
    :return: (min(N, M), V) rotated vectors.
    """
    data = as_float32(data, device)
    if torch.is_tensor(roll_values):
        roll_values = roll_values.cpu().numpy()
    roll_values = np.asarray(roll_values)
    n = min(data.shape[0], roll_values.shape[0])
    data = data[:n]
    v = data.shape[1]
    shifts = torch.cumsum(
        torch.from_numpy(roll_values[:n].astype(np.int32)).to(data.device), dim=0)
    idx = (torch.arange(v, device=data.device)[None, :] + shifts[:, None]) % v
    return torch.gather(data, 1, idx)


def maximum_filter1d(x, size: int, device: Device = "cuda") -> torch.Tensor:
    """
    scipy.ndimage.maximum_filter1d (mode='reflect'): a rolling max over a
    centered window, left-biased for even sizes (window [i - size//2,
    i + (size-1)//2]); scipy's 'reflect' repeats the edge sample.
    """
    x = as_float32(x, device)
    n = x.shape[0]
    left = size // 2
    right = size - left - 1
    position = torch.arange(-left, n + right, device=x.device) % (2 * n)
    padded = x[torch.where(position < n, position, 2 * n - 1 - position)]
    return padded.unfold(0, size, 1).amax(dim=1)
