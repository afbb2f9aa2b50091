"""
WAV ingest + video-locked time stretching (a copy of gance_tpu/audio/io.py, which
follows the reference gance/vector_sources/music.py). Host-only: numpy and scipy.

The resampy dependency is replaced with scipy polyphase resampling wrapped to honor
resampy's output-length contract (n_out = floor(n * sr_new / sr_orig)) — the length
contract is what the downstream frame-count math depends on
(projection_file_blend.py:140-146 validates |latents - frames| <= 2).
"""

import pickle
from fractions import Fraction
from pathlib import Path
from typing import List, NamedTuple, Optional, Union

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from gance_tpu_torch.utils.logging import LOGGER


class WavFileProperties(NamedTuple):
    """Sample rate + amplitude data + label (reference music.py:20-34)."""

    sample_rate: int
    wav_data: np.ndarray
    name: str


def _remap(data: np.ndarray, input_range, output_range) -> np.ndarray:
    in0, in1 = input_range
    out0, out1 = output_range
    return (data.astype(np.float64) - in0) * ((out1 - out0) / (in1 - in0)) + out0


def _to_float32(wav_data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1] (reference music.py:172-209 dynamic
    ranges: int32/int16 symmetric, uint8 0..255)."""
    if wav_data.dtype == np.float32:
        return wav_data
    if wav_data.dtype == np.int32:
        wav_data = _remap(wav_data, (-2147483648, 2147483647), (-1, 1))
    elif wav_data.dtype == np.int16:
        wav_data = _remap(wav_data, (-32768, 32767), (-1, 1))
    elif wav_data.dtype == np.uint8:
        wav_data = _remap(wav_data, (0, 255), (-1, 1))
    else:
        raise ValueError(f"Cannot safely convert wav dtype {wav_data.dtype} to float32")
    return wav_data.astype(np.float32)


def read_wav_file(wav_path: Path, convert_to_32bit_float: bool = True) -> WavFileProperties:
    """Read a wav file with the reference's PCM scaling (music.py:172-209)."""
    sample_rate, wav_data = wavfile.read(str(wav_path))

    if convert_to_32bit_float:
        wav_data = _to_float32(wav_data)

    return WavFileProperties(
        sample_rate=int(sample_rate),
        wav_data=wav_data,
        name=Path(wav_path).with_suffix("").name,
    )


def read_wav_bytes(
    data: bytes, name: str = "request", convert_to_32bit_float: bool = True
) -> WavFileProperties:
    """read_wav_file over in-memory bytes — the online serving path receives
    WAV content in a request body, never via a filesystem path."""
    import io

    sample_rate, wav_data = wavfile.read(io.BytesIO(data))
    if convert_to_32bit_float:
        wav_data = _to_float32(wav_data)
    return WavFileProperties(
        sample_rate=int(sample_rate), wav_data=wav_data, name=name
    )


def resample_time_stretch(
    data: np.ndarray, sr_orig: float, sr_new: float
) -> np.ndarray:
    """
    Time-stretch audio by resampling (the resampy.resample role at music.py:212-230).
    Polyphase filtering via a rational approximation of the rate ratio, then
    trimmed/padded to resampy's exact output-length contract:
    n_out = int(n * sr_new / sr_orig).
    """
    n = data.shape[0]
    n_out = int(n * sr_new / sr_orig)
    frac = Fraction(sr_new / sr_orig).limit_denominator(10000)
    up, down = frac.numerator, frac.denominator
    y = resample_poly(data.astype(np.float64), up, down).astype(np.float32)
    if y.shape[0] >= n_out:
        return y[:n_out]
    return np.pad(y, (0, n_out - y.shape[0]))


def pad_array(array: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a 1D array to `size` (reference vector_sources_common.py:33)."""
    return np.pad(array, (0, size - len(array)), mode="constant", constant_values=0)


def read_wavs_scale_for_video(
    wavs: Union[List[Path], List[WavFileProperties]],
    vector_length: int,
    frames_per_second: Optional[float] = None,
    target_num_vectors: Optional[int] = None,
    cache_path: Optional[Path] = None,
    pad_to_length: bool = True,
) -> WavFileProperties:
    """
    Concatenate wavs to mono, time-stretch so samples = vector_length × num_frames,
    zero-pad to a vector_length multiple. FPS mode derives frame count from duration;
    target mode locks to a projection file's frame count. Optional pickle cache.
    Reference music.py:60-169 (including the single-sample-rate restriction and the
    integer truncation of the fps-mode scaled sample rate).
    """
    if frames_per_second is not None and target_num_vectors is not None:
        raise ValueError("Can't use both FPS mode and target vector count mode.")
    if frames_per_second is None and target_num_vectors is None:
        raise ValueError("Need to use FPS mode or target vector count mode.")

    if cache_path is not None and Path(cache_path).exists():
        LOGGER.info("Cached audio found at %s. Loading.", cache_path)
        with open(str(cache_path), "rb") as read_file:
            return pickle.load(read_file)

    input_wavs = [
        read_wav_file(wav) if isinstance(wav, (str, Path)) else wav for wav in wavs
    ]

    sample_rates = {w.sample_rate for w in input_wavs}
    if len(sample_rates) != 1:
        raise ValueError("Multiple sample rates for input audio files is unsupported.")
    sample_rate = next(iter(sample_rates))

    mono = np.concatenate(
        [
            w.wav_data.mean(axis=1) if w.wav_data.ndim > 1 else w.wav_data
            for w in input_wavs
        ]
    )
    name = "_".join(w.name for w in input_wavs) + "_mono"
    num_samples = mono.shape[0]

    if frames_per_second is not None:
        scaled_sample_rate: float = int(
            sample_rate
            * (vector_length * (frames_per_second * (num_samples / sample_rate)))
            / num_samples
        )
    else:
        original_num_vectors = num_samples / vector_length
        ratio = target_num_vectors / original_num_vectors
        scaled_sample_rate = float(sample_rate) * ratio

    scaled = resample_time_stretch(mono, sample_rate, scaled_sample_rate)

    if pad_to_length:
        scaled = pad_array(
            scaled, int(np.ceil(scaled.shape[0] / vector_length) * vector_length)
        )

    output = WavFileProperties(
        wav_data=scaled, sample_rate=sample_rate, name=f"{name}_scaled_padded"
    )

    if cache_path is not None:
        with open(str(cache_path), "wb") as write_file:
            pickle.dump(output, write_file)
    return output


def write_wav_file(path: Path, wav: WavFileProperties) -> None:
    """Write float32 PCM wav (utility for tests + audio mux)."""
    wavfile.write(str(path), wav.sample_rate, wav.wav_data)


def fabricate_percussive_wav(
    path: Path,
    seconds: float = 2.0,
    sample_rate: int = 44100,
    dtype: str = "int16",
) -> Path:
    """
    A deterministic percussive synthetic track (decaying noise bursts — 4
    "claps" per second — over a rising chirp) for self-contained demos, tests,
    and benches on hosts with no real audio assets. `dtype` picks the PCM
    encoding: "int16" (demo deliverables) or "float32" (DSP benches).
    """
    rng = np.random.RandomState(42)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    signal = 0.3 * np.sin(2 * np.pi * (110 + 220 * t) * t)
    for onset in np.arange(0.0, seconds, 0.25):
        start = int(onset * sample_rate)
        length = min(int(0.05 * sample_rate), signal.size - start)
        if length > 0:
            envelope = np.exp(-np.arange(length) / (0.01 * sample_rate))
            signal[start : start + length] += 0.7 * envelope * rng.randn(length)
    clipped = np.clip(signal, -1.0, 1.0)
    data = (
        (clipped * 32767).astype(np.int16)
        if dtype == "int16"
        else clipped.astype(np.float32)
    )
    write_wav_file(
        path, WavFileProperties(wav_data=data, sample_rate=sample_rate, name=path.stem)
    )
    return path
