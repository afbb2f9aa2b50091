"""
A copy of gance_tpu/audio/primitives.py (numpy and scipy.ndimage, host-only).

Synthetic latent sources — lines, sweeps, seeded gaussian noise fields
(reference gance/vector_sources/primatives.py; SURVEY.md §2.3; note the reference's
filename typo is not preserved).

`gaussian_data` is THE noise source for the noise_blend pipeline; it stays host-side
numpy because its value contract is "seeded RandomState.randn gaussian-filtered with
scipy wrap-mode" — a one-shot O(frames × 512) init whose exact values golden tests
depend on (DEFAULT_RANDOM_SEED=1234).
"""

from typing import NamedTuple, Optional

import numpy as np
import scipy.ndimage

DEFAULT_RANDOM_SEED = 1234


class Sigmas(NamedTuple):
    """Gaussian smoothing widths across/within vectors (reference primatives.py:37)."""

    across_vectors: float
    within_vectors: float


def gaussian_data(
    vector_length: int,
    num_vectors: int,
    sigmas: Sigmas = Sigmas(20, 0),
    random_state: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """
    Seeded gaussian noise, smoothed across time (and optionally within vectors) with
    wrap-mode filtering, RMS-normalized (reference :49-74). Returns flat
    ConcatenatedVectors (num_vectors * vector_length,) float32.
    """
    if random_state is None:
        random_state = np.random.RandomState(DEFAULT_RANDOM_SEED)

    all_latents = random_state.randn(num_vectors, 1, vector_length).astype(np.float32)
    all_latents = scipy.ndimage.gaussian_filter(
        input=all_latents,
        sigma=(sigmas.across_vectors, 0, sigmas.within_vectors),
        mode="wrap",
    )
    all_latents /= np.sqrt(np.mean(np.square(all_latents)))
    return all_latents.reshape(vector_length * num_vectors)


def line_sweep(
    start_value: float, stop_value: float, vector_length: int, num_vectors: int
) -> np.ndarray:
    """Constant vector sweeping between two values over time (reference :20-34)."""
    return np.repeat(np.linspace(start_value, stop_value, vector_length), num_vectors)


def single_square_wave_vector(
    rising_edge_x: int,
    falling_edge_x: int,
    y_offset: float,
    y_amplitude: float,
    vector_length: int,
) -> np.ndarray:
    """One square-pulse vector; edges inclusive (reference :77-97)."""
    xs = np.arange(vector_length)
    return np.where(
        (xs >= rising_edge_x) & (xs <= falling_edge_x), y_amplitude, y_offset
    ).astype(np.float64)


def square_wave_sweep_horizontal(
    vector_length: int, pulse_width: int, y_offset: int = 0, y_amplitude: int = 10
) -> np.ndarray:
    """Square pulse swept left→right across vectors (reference :100-126)."""
    return np.concatenate(
        [
            single_square_wave_vector(
                rising_edge_x=value,
                falling_edge_x=value + pulse_width,
                y_amplitude=y_amplitude,
                y_offset=y_offset,
                vector_length=vector_length,
            )
            for value in np.arange(y_offset, y_amplitude)
        ]
    )


def square_wave_sweep_vertical(
    vector_length: int,
    rising_edge_x: int,
    pulse_width: int,
    y_offset: int = -10,
    y_amplitude: int = 10,
    step_size: float = 1.0,
) -> np.ndarray:
    """Square pulse growing in amplitude across vectors (reference :129-162)."""
    return np.concatenate(
        [
            single_square_wave_vector(
                y_offset=y_offset,
                y_amplitude=value,
                vector_length=vector_length,
                rising_edge_x=rising_edge_x,
                falling_edge_x=rising_edge_x + pulse_width,
            )
            for value in np.arange(y_offset, y_amplitude, step_size)
        ]
    )


def single_sine_wave_vector(vector_length: int, y_amplitude: float) -> np.ndarray:
    """Sine across the vector (reference :165-175)."""
    return np.sin(np.arange(0, vector_length, 1)) * y_amplitude
