"""
Doc-by-example invocations of the visualization stack (the counterpart of
gance_tpu/viz/examples.py; reference gance/data_into_network_visualization/
visualization_examples.py + the primitives' demo functions). Each example
renders to files under an output directory instead of opening interactive
windows.

The audio DSP of the examples that read a WAV, and the synthesis of the two
that build a network, run on `device` ("cuda" by default; raises on a host
without CUDA). `blog_media_demo` and `quick_look_demo` build their random
network with the port's `init_generator_params(0, config)` (a seeded numpy
RandomState), not gance_tpu's threefry key 0, so their synthesised halves
differ from gance_tpu's; the `network` argument takes any network instead.
"""

from pathlib import Path
from typing import Optional

import numpy as np

from gance_tpu_torch.audio.primitives import Sigmas, gaussian_data, square_wave_sweep_vertical
from gance_tpu_torch.audio.vectors import to_numpy
from gance_tpu_torch.media.images import write_image
from gance_tpu_torch.types import VectorsLabel
from gance_tpu_torch.utils.device import Device
from gance_tpu_torch.viz.vectors_3d import (
    multi_plot_vectors,
    plot_vectors_3d,
    visualize_data_with_spectrogram_and_3d_vectors,
)


def sigmas_demo(output_directory: Path, vector_length: int = 256) -> Path:
    """Visualize the effect of the gaussian-noise sigma parameter (reference
    primatives.py sigmas_demo)."""
    frame = multi_plot_vectors(
        [
            VectorsLabel(
                data=gaussian_data(
                    vector_length=vector_length, num_vectors=50,
                    sigmas=Sigmas(sigma, sigma),
                ),
                label=f"gaussian, sigma: {sigma}",
                vector_length=vector_length,
            )
            for sigma in (1, 20, 80)
        ],
        side_length=300,
    )
    out = Path(output_directory) / "sigmas_demo.png"
    write_image(frame, out)
    return out


def vertical_sweep_demo(output_directory: Path, vector_length: int = 100,
                        device: Device = "cuda") -> Path:
    """Square-wave sweep composite (reference primatives.py vertical_sweep_demo)."""
    data = square_wave_sweep_vertical(
        vector_length=vector_length, rising_edge_x=0, pulse_width=50,
        y_offset=0, y_amplitude=5,
    )
    frame = visualize_data_with_spectrogram_and_3d_vectors(
        VectorsLabel(data=data, vector_length=vector_length, label="Vertical Sweep"),
        side_length=300,
        device=device,
    )
    out = Path(output_directory) / "vertical_sweep_demo.png"
    write_image(frame, out)
    return out


def waterfall_demo(output_directory: Path) -> Path:
    """Single 3D waterfall of smoothed noise."""
    data = gaussian_data(vector_length=128, num_vectors=60, sigmas=Sigmas(30, 0))
    frame = plot_vectors_3d(
        VectorsLabel(data=data, vector_length=128, label="smoothed noise"),
        current_index=30,
    )
    out = Path(output_directory) / "waterfall_demo.png"
    write_image(frame, out)
    return out


def smoothing_demo(output_directory: Path, wav_path: Path, vector_length: int = 1000,
                   device: Device = "cuda") -> Path:
    """
    Raw vs smoothed audio spectrogram side by side (reference
    visualization_examples.py `demo_smoothing`).
    """
    from gance_tpu_torch.audio.io import read_wav_file
    from gance_tpu_torch.audio.spectrogram import compute_spectrogram, reshape_spectrogram_to_vectors
    from gance_tpu_torch.audio.vectors import smooth_across_vectors

    audio = read_wav_file(Path(wav_path)).wav_data
    spectrogram = to_numpy(reshape_spectrogram_to_vectors(
        spectrogram_data=compute_spectrogram(np.asarray(audio), vector_length, device=device),
        vector_length=vector_length,
        device=device,
    ))
    smoothed = smooth_across_vectors(spectrogram, vector_length, device=device)
    frame = multi_plot_vectors(
        [
            VectorsLabel(spectrogram, vector_length, "Spectrogram"),
            VectorsLabel(smoothed, vector_length, "Smooth Spectrogram"),
        ],
        side_length=300,
    )
    out = Path(output_directory) / "smoothing_demo.png"
    write_image(frame, out)
    return out


def rotation_demo(output_directory: Path, wav_path: Path, vector_length: int = 512,
                  device: Device = "cuda") -> Path:
    """
    Effect of rotating concatenated vectors over time, plus a short rendered
    video of the rotated stream (reference `demo_rotation`).
    """
    from gance_tpu_torch.audio.dsp import rotate_vectors_over_time
    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.audio.spectrogram import compute_spectrogram_smooth_scale
    from gance_tpu_torch.viz.panels import vectors_to_video

    audio = read_wavs_scale_for_video(
        wavs=[Path(wav_path)], vector_length=vector_length, frames_per_second=60.0
    ).wav_data
    spectrogram = to_numpy(
        compute_spectrogram_smooth_scale(
            data=audio, vector_length=vector_length, amplitude_range=(-10.0, 10.0),
            device=device,
        )
    )
    num_vectors = spectrogram.shape[0] // vector_length
    rotated = to_numpy(
        rotate_vectors_over_time(
            spectrogram.reshape(num_vectors, vector_length),
            np.full((num_vectors,), 10),
            device=device,
        )
    ).reshape(-1)

    frame = multi_plot_vectors(
        [
            VectorsLabel(spectrogram, vector_length, "Raw Spectrogram"),
            VectorsLabel(rotated, vector_length, "Rotated"),
        ],
        side_length=300,
    )
    out = Path(output_directory) / "rotation_demo.png"
    write_image(frame, out)
    vectors_to_video(
        data=rotated[: vector_length * min(num_vectors, 15)],
        vector_length=vector_length,
        output_path=Path(output_directory) / "rotation_demo.mp4",
        video_fps=15.0,
        side_length=300,
    )
    return out


def reducer_demo(output_directory: Path, wav_path: Path, device: Device = "cuda") -> Path:
    """
    How a song reduces to network indices (reference
    `demo_visualize_reducer_output`).
    """
    from gance_tpu_torch.audio.reduction import reduce_vector_gzip_compression_rolling_average
    from gance_tpu_torch.viz.reduction_viz import visualize_reducer_output

    out = Path(output_directory) / "reducer_demo.png"
    visualize_reducer_output(
        Path(wav_path),
        reduce_vector_gzip_compression_rolling_average,
        output_image_path=out,
        device=device,
    )
    return out


def synthesis_frame_demo(output_directory: Path, wav_path: Path, vector_length: int = 1000,
                         device: Device = "cuda") -> Path:
    """
    One frame of the synthesis debug pane: the noise_blend input synthesizer
    feeding the 2x2 panel renderer (reference `data_visualizations_single_frame`).
    """
    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
    from gance_tpu_torch.synthesis.orchestration import frame_inputs
    from gance_tpu_torch.viz.panels import synthesis_visualizer

    audio = read_wavs_scale_for_video(
        wavs=[Path(wav_path)], vector_length=vector_length, frames_per_second=60.0
    ).wav_data
    data = alpha_blend_vectors_max_rms_power_audio(
        alpha=0.5,
        fft_roll_enabled=False,
        fft_amplitude_range=(-4.0, 4.0),
        time_series_audio_vectors=audio,
        vector_length=vector_length,
        network_indices=list(range(20)),
        device=device,
    )
    inputs = frame_inputs(data)
    render = synthesis_visualizer(side_length=300)
    frame = render(inputs[min(18, len(inputs) - 1)])
    out = Path(output_directory) / "synthesis_frame_demo.png"
    write_image(frame, out)
    return out


def _demo_network(resolution: int, device: Device):
    """The examples' random-init network: the port's seeded params (seed 0)
    of gance_tpu's demo config, on `device`."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig, init_generator_params
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    config = GeneratorConfig(
        resolution=resolution, fmap_base=512, fmap_max=64, latent_size=64,
        dlatent_size=64, mapping_layers=2, mapping_fmaps=64,
    )
    return SynthesisNetwork(params=init_generator_params(0, config), config=config,
                            device=device)


def blog_media_demo(output_directory: Path, resolution: int = 32, device: Device = "cuda",
                    network: Optional[object] = None) -> Path:
    """
    The blog-post media suite (reference visualization_examples.py:175-278
    `blog_post_media`): quick-look images of a projection file's final latents
    at three scales, then a line, sine wave, noise, and square wave pushed
    through the same network. The reference renders these from the artist's
    private production network + projection file; this demo fabricates both
    (a tiny random-init network and a projection file holding its mapped
    latents) so the walk-through runs on any host.

    :param network: the network to push the vectors through (a
        SynthesisNetwork-like object with a `config`); None builds the
        random-init demo network on `device`.
    """
    from gance_tpu_torch.audio.primitives import single_square_wave_vector
    from gance_tpu_torch.projection.file_reader import load_projection_file
    from gance_tpu_torch.projection.file_writer import ProjectionFileWriter
    from gance_tpu_torch.projection.projection_types import LATEST_VERSION, ProjectionAttributes
    from gance_tpu_torch.viz.one_shot import single_vector_single_network_visualization

    output_directory = Path(output_directory)
    if network is None:
        network = _demo_network(resolution, device)
    config = network.config

    # Fabricate the projection file the reference reads its finals from.
    projection_path = output_directory / "blog_media_projection.hdf5"
    frame_count = 3
    attrs = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=True, original_target_path="demo",
        original_width_height=(resolution, resolution),
        projection_width_height=(resolution, resolution),
        target_md5_hash="0" * 32, original_network_path="demo",
        network_md5_hash="0" * 32, steps_in_projection=1, noises_shapes=np.nan,
        latents_histories_enabled=False, noises_histories_enabled=False,
        images_histories_enabled=False, original_fps=30.0, projection_fps=30.0,
        original_frame_count=frame_count, projection_frame_count=frame_count,
    )
    rng = np.random.RandomState(2)
    with ProjectionFileWriter(projection_path, attrs) as writer:
        for _ in range(frame_count):
            with writer.frame_writer() as frame_writer:
                target = rng.randint(
                    0, 255, (resolution, resolution, 3), np.uint8
                )
                latents = np.tile(
                    rng.randn(config.dlatent_size).astype(np.float32),
                    (1, config.num_style_rows, 1),
                )
                frame_writer.finish(target, latents, target)

    with load_projection_file(projection_path) as reader:
        finals = reader.final_latents_at_frame(frame_count - 1)

    y_range = (-20.0, 20.0)
    outputs = [
        (finals, "Projection File Original Final Latents",
         "projection_final_original.png"),
        (finals * 0.9, "Projection File Original Final Latents",
         "projection_final_small.png"),
        (finals * 1.1, "Projection File Original Final Latents",
         "projection_final_large.png"),
        (np.full((config.latent_size,), 10.0, np.float32),
         "Line", "line_to_image.png"),
        ((np.sin(np.arange(0, config.latent_size / 10, 0.1)) * 10).astype(np.float32),
         "Sine Wave", "sine_wav_to_image.png"),
        (rng.rand(config.latent_size).astype(np.float32) * 10,
         "Noise", "noise_image.png"),
        (single_square_wave_vector(
            rising_edge_x=10, falling_edge_x=40, y_offset=0, y_amplitude=10,
            vector_length=config.latent_size,
        ), "Square Wave", "original_step.png"),
    ]
    for vector, title, filename in outputs:
        single_vector_single_network_visualization(
            vector=vector, title=title,
            output_image_path=output_directory / filename,
            network=network, image_height=resolution * 4, y_range=y_range,
        )
    return output_directory / "projection_final_original.png"


def quick_look_demo(output_directory: Path, resolution: int = 32, device: Device = "cuda",
                    network: Optional[object] = None) -> Path:
    """
    The one-shot [scatter | synthesis] quick-look over a random-init network
    (reference network_visualization.py:704-800 via viz/one_shot.py).

    :param network: as `blog_media_demo`'s.
    """
    from gance_tpu_torch.viz.one_shot import (
        single_vector_single_network_visualization,
        vectors_single_network_visualization,
    )

    if network is None:
        network = _demo_network(resolution, device)
    latent_size = network.config.latent_size
    rng = np.random.RandomState(0)
    out = Path(output_directory) / "quick_look.png"
    single_vector_single_network_visualization(
        vector=rng.randn(latent_size).astype(np.float32),
        title="one vector",
        output_image_path=out,
        network=network,
        image_height=resolution * 4,
    )
    vectors_single_network_visualization(
        vectors_label=VectorsLabel(
            data=rng.randn(6 * latent_size).astype(np.float32),
            vector_length=latent_size,
            label="six vectors",
        ),
        output_video_path=Path(output_directory) / "quick_look.mp4",
        network=network,
        video_height=resolution * 4,
        video_fps=10.0,
    )
    return out
