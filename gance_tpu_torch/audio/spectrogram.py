"""
Audio spectrogram -> latent-vector transform, in torch on the caller's device
(the counterpart of gance_tpu/audio/spectrogram.py).

The reference's quirks are kept exactly:
  * its operator-precedence slip `m = num_frequency_bins - 1 * 2`: each window
    is vector_length - 2 samples wide and steps by vector_length;
  * the window function is np.hanning(m + 1)[:-1];
  * the truncated FFT keeps only the first m // 2 bins;
  * the output is 20 * log10(s / max(s)): a window of digital silence gives
    -inf, which turns into NaN in the resample and `minmax_scale`.

One departure from gance_tpu, which computes every stage in float32: the
windowed FFT and its dB values are computed in float64, as the reference's
numpy code does, and rounded to float32 after. On narrowband audio (a tone
between drum hits) most bins lie at the rounding noise of a float32 FFT, and
the global minimum that `minmax_scale` maps to the low end is one of them.
There two float32 FFTs (XLA's, pocketfft, cuFFT) differ by decibels, which
moves the whole scaled spectrogram far past float32 rounding
(tools/spectrogram_float32_floor.py measures it against a float64 numpy
derivation). In float64 those bins are the window's true leakage, and the
card and the CPU agree to float32 rounding.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from gance_tpu_torch.audio.dsp import as_float32, fourier_resample, minmax_scale, savgol_smooth
from gance_tpu_torch.utils.device import Device


def compute_spectrogram(
    data, num_frequency_bins: int, truncate: bool = True, device: Device = "cuda"
) -> torch.Tensor:
    """
    Hanning-windowed strided FFT magnitude in dB, normalized to the global max.

    :param data: mono audio (S,); stereo (S, 2) is averaged to mono.
    :param num_frequency_bins: the "vector length"; windows are this minus 2
        samples wide and step by exactly this many samples.
    :return: (freq_bins, num_windows): rows are frequencies over time;
        freq_bins is (num_frequency_bins - 2) // 2 when truncated.
    """
    data = as_float32(data, device)
    if data.ndim > 1:
        data = data.mean(dim=1)
    m = num_frequency_bins - 1 * 2  # the reference's quirk: == vector_length - 2
    slices = data.unfold(0, m, num_frequency_bins).double()  # (num_windows, m)
    slices = slices * torch.from_numpy(np.hanning(m + 1)[:-1]).to(data.device)
    if truncate:
        spectrum = torch.fft.rfft(slices, dim=1).T[: m // 2]
    else:
        spectrum = torch.fft.fft(slices, dim=1).T
    s = spectrum.abs()
    return (20.0 * torch.log10(s / s.max())).float()


def reshape_spectrogram_to_vectors(
    spectrogram_data,
    vector_length: int,
    amplitude_range: Optional[Tuple[float, float]] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """
    Transpose (freq, time) -> per-time vectors, Fourier-resample each vector
    from freq_bins to `vector_length`, optionally minmax-scale the whole signal.
    Returns flat ConcatenatedVectors (num_windows * vector_length,).
    """
    transposed = as_float32(spectrogram_data, device).T  # (time, freq)
    flat = fourier_resample(transposed, vector_length, axis=-1, device=device).reshape(-1)
    if amplitude_range is not None:
        flat = minmax_scale(flat, feature_range=tuple(amplitude_range), device=device)
    return flat


def compute_spectrogram_smooth_scale(
    data,
    vector_length: int,
    amplitude_range: Optional[Tuple[float, float]] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """
    The canonical audio -> latent transform: spectrogram -> per-vector
    resample/scale -> smooth across vectors (savgol 7/3 along time per latent
    dim) -> smooth within each vector (savgol 5/3). Returns flat
    ConcatenatedVectors on `device`.
    """
    spectrogram = compute_spectrogram(data, vector_length, device=device)
    flat = reshape_spectrogram_to_vectors(
        spectrogram, vector_length, amplitude_range=amplitude_range, device=device
    )
    divided = flat.reshape(-1, vector_length)  # (N, V)
    across = savgol_smooth(divided, window_length=7, polyorder=3, axis=0, device=device)
    within = savgol_smooth(across, window_length=5, polyorder=3, axis=1, device=device)
    return within.reshape(-1)
