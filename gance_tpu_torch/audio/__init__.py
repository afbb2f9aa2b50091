"""
The audio and feature layer of the port (the counterpart of gance_tpu/audio/):
WAV ingest and time stretching on the host (numpy, scipy), the vector DSP
chain (spectrogram, Fourier resample, savgol smoothing, minmax scaling, FFT
roll) as torch on the caller's device, and the per-frame RMS reducers that
select networks.
"""

from gance_tpu_torch.audio.io import WavFileProperties, read_wav_file, read_wavs_scale_for_video
from gance_tpu_torch.audio.spectrogram import (
    compute_spectrogram,
    compute_spectrogram_smooth_scale,
    reshape_spectrogram_to_vectors,
)

__all__ = [
    "WavFileProperties",
    "read_wav_file",
    "read_wavs_scale_for_video",
    "compute_spectrogram",
    "compute_spectrogram_smooth_scale",
    "reshape_spectrogram_to_vectors",
]
