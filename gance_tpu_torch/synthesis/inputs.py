"""
Input synthesis: turn time-series audio (+ optionally a projection file's
final latents) into the vector/matrix stream fed to synthesis, plus the
per-frame network-index stream (the counterpart of
gance_tpu/synthesis/inputs.py, with the same semantics, including the
"rows-identical shortcut" for projection final latents and the projection
variant's tighter savgol(3, 2) index smoothing).

The audio DSP runs in torch on `device` (default "cuda"); the seeded noise
field is host numpy (its values are the contract); the outputs are numpy.
"""

from typing import List, NamedTuple, Tuple, Union

import numpy as np

from gance_tpu_torch.audio import vectors as vsc
from gance_tpu_torch.audio.dsp import minmax_scale
from gance_tpu_torch.audio.primitives import Sigmas, gaussian_data
from gance_tpu_torch.audio.reduction import (
    quantize_results_layers,
    reduce_vector_rms_rolling_average,
)
from gance_tpu_torch.audio.spectrogram import compute_spectrogram_smooth_scale
from gance_tpu_torch.types import MatricesLabel, ResultLayers, VectorsLabel
from gance_tpu_torch.utils.device import Device


class VisualizationInput(NamedTuple):
    """
    The synthesis pipeline's contract (reference visualization_common.py:65-87):
    two source streams, their combination (what the network actually consumes), and
    the per-frame network index stream.
    """

    a_vectors: Union[VectorsLabel, MatricesLabel]
    b_vectors: Union[VectorsLabel, MatricesLabel]
    combined: Union[VectorsLabel, MatricesLabel]
    network_indices: ResultLayers


def create_spectrogram(
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    fft_amplitude_range: Tuple[float, float],
    fft_roll_enabled: bool,
    device: Device = "cuda",
) -> np.ndarray:
    """
    Smoothed/scaled spectrogram, optionally FFT-rolled by quantized RMS (0..2) and
    re-smoothed (reference visualization_inputs.py:53-91).
    """
    spectrogram = vsc.to_numpy(
        compute_spectrogram_smooth_scale(
            np.asarray(time_series_audio_vectors),
            vector_length,
            amplitude_range=tuple(fft_amplitude_range),
            device=device,
        )
    )

    if fft_roll_enabled:
        roll_values = quantize_results_layers(
            results_layers=reduce_vector_rms_rolling_average(
                time_series_audio_vectors=time_series_audio_vectors,
                vector_length=vector_length,
                device=device,
            ),
            network_indices=list(np.arange(0, 3)),
            device=device,
        )
        spectrogram = vsc.smooth_each_vector(
            data=vsc.rotate_vectors_over_time(
                data=spectrogram,
                vector_length=vector_length,
                roll_values=roll_values.result.data,
                device=device,
            ),
            vector_length=vector_length,
            device=device,
        )

    return spectrogram


def alpha_blend_vectors_max_rms_power_audio(
    alpha: float,
    fft_roll_enabled: bool,
    fft_amplitude_range: Tuple[float, float],
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    network_indices: List[int],
    device: Device = "cuda",
) -> VisualizationInput:
    """
    noise_blend input synthesis (reference visualization_inputs.py:94-166):
    spectrogram alpha-blended with seeded gaussian noise (Sigmas(50, 0), scaled to
    (-4, 4)); indices from quantized smoothed RMS.
    """
    spectrogram = create_spectrogram(
        time_series_audio_vectors=time_series_audio_vectors,
        vector_length=vector_length,
        fft_amplitude_range=fft_amplitude_range,
        fft_roll_enabled=fft_roll_enabled,
        device=device,
    )

    num_vectors = int(spectrogram.shape[0] / vector_length)

    noise = vsc.to_numpy(
        minmax_scale(
            gaussian_data(
                vector_length=vector_length,
                num_vectors=num_vectors,
                sigmas=Sigmas(across_vectors=50, within_vectors=0),
            ),
            feature_range=(-4.0, 4.0),
            device=device,
        )
    )

    combined = noise * (1.0 - alpha) + spectrogram * alpha

    indices_layers = quantize_results_layers(
        results_layers=reduce_vector_rms_rolling_average(
            time_series_audio_vectors=time_series_audio_vectors,
            vector_length=vector_length,
            device=device,
        ),
        network_indices=network_indices,
        device=device,
    )

    return VisualizationInput(
        a_vectors=VectorsLabel(
            data=spectrogram, vector_length=vector_length, label="Audio Spectrogram"
        ),
        b_vectors=VectorsLabel(
            data=noise, vector_length=vector_length, label="Gaussian Smoothed Noise"
        ),
        combined=VectorsLabel(
            data=combined,
            vector_length=vector_length,
            label=f"Combined w/ Alpha Blending, a={alpha}",
        ),
        network_indices=indices_layers,
    )


def alpha_blend_projection_file(
    final_latents_matrices_label: MatricesLabel,
    alpha: float,
    fft_roll_enabled: bool,
    fft_amplitude_range: Tuple[float, float],
    blend_depth: int,
    time_series_audio_vectors: np.ndarray,
    vector_length: int,
    network_indices: List[int],
    device: Device = "cuda",
) -> VisualizationInput:
    """
    projection_file_blend input synthesis (reference visualization_inputs.py:169-270):
    the spectrogram is alpha-blended into the first `blend_depth` of the style rows;
    rows blend_depth..num_rows stay pure projection latents. Exploits the
    rows-identical property of projector outputs (verified by the projection-file
    reader) to duplicate row 0 instead of interpolating matrices.
    """
    spectrogram = create_spectrogram(
        time_series_audio_vectors=time_series_audio_vectors,
        vector_length=vector_length,
        fft_amplitude_range=fft_amplitude_range,
        fft_roll_enabled=fft_roll_enabled,
        device=device,
    )

    num_vectors = int(vsc.underlying_length(spectrogram) / vector_length)
    num_rows = final_latents_matrices_label.data.shape[0]

    projected_vectors = vsc.promote_to_matrix_duplicate(
        data=vsc.duplicate_to_vector_count(
            data=vsc.demote_to_vector_select(
                final_latents_matrices_label.data, index_to_take=0
            ),
            vector_length=vector_length,
            target_vector_count=num_vectors,
        ),
        target_depth=num_rows,
    )

    alpha_blended = vsc.promote_to_matrix_duplicate(
        vsc.demote_to_vector_select(projected_vectors, 0) * (1.0 - alpha)
        + spectrogram * alpha,
        blend_depth,
    )

    combined = np.concatenate((alpha_blended, projected_vectors[blend_depth:num_rows]))

    indices_layers = quantize_results_layers(
        results_layers=reduce_vector_rms_rolling_average(
            time_series_audio_vectors=time_series_audio_vectors,
            vector_length=vector_length,
            savgol_window_length=3,
            savgol_polyorder=2,
            device=device,
        ),
        network_indices=network_indices,
        device=device,
    )

    return VisualizationInput(
        a_vectors=VectorsLabel(
            data=spectrogram, vector_length=vector_length, label="Rolled Audio Spectrogram"
        ),
        b_vectors=MatricesLabel(
            data=projected_vectors,
            vector_length=vector_length,
            label=final_latents_matrices_label.label,
        ),
        combined=MatricesLabel(
            data=combined,
            vector_length=vector_length,
            label=f"Combined w/ Alpha Blending, a={alpha}",
        ),
        network_indices=indices_layers,
    )


def slice_visualization_input(
    data: VisualizationInput, start_frame: int
) -> VisualizationInput:
    """
    The tail of a VisualizationInput from `start_frame` on, the resume
    primitive (gance_tpu's media/resume.py): every stream is a precomputed array, so a
    resumed render SLICES the inputs instead of replaying synthesis of the
    already-durable frames. Frame f of the slice equals frame start_frame + f
    of the original exactly (pure indexing, no recomputation).
    """
    if start_frame == 0:
        return data

    def slice_data_label(data_label):
        return data_label._replace(data=np.asarray(data_label.data)[start_frame:])

    indices = data.network_indices
    return VisualizationInput(
        a_vectors=data.a_vectors._replace(
            data=np.asarray(data.a_vectors.data)[..., start_frame * data.a_vectors.vector_length :]
        ),
        b_vectors=data.b_vectors._replace(
            data=np.asarray(data.b_vectors.data)[..., start_frame * data.b_vectors.vector_length :]
        ),
        combined=data.combined._replace(
            data=np.asarray(data.combined.data)[..., start_frame * data.combined.vector_length :]
        ),
        network_indices=ResultLayers(
            result=slice_data_label(indices.result),
            layers=[slice_data_label(layer) for layer in indices.layers],
        ),
    )
