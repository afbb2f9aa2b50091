"""
Projection analytics and visualizations (the counterpart of
gance_tpu/projection/visualization.py; reference gance/projection/
projection_visualization.py): convergence analysis of latent histories, the
[latents plot | target | final image] triptych video, and history
re-synthesis.

Each function that opens a file keeps gance_tpu's signature and wraps a
reader-level generator (`final_latents_frames`, `projection_history_frames`,
`partial_projection_history_frames`) that takes any reader with the
ProjectionFileReader members it reads, so that a host without h5py can
drive them from memory. Re-synthesis runs on `device` ("cuda" by default;
raises on a host without CUDA), RESYNTHESIS_BATCH latents per forward
where gance_tpu runs one.

matplotlib is imported only by the functions that draw (the triptych and
the convergence plot), inside them.
"""

import itertools
from itertools import tee
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from gance_tpu_torch.media.images import horizontal_concat_images
from gance_tpu_torch.media.video import write_source_to_disk_consume
from gance_tpu_torch.projection.file_reader import (
    images_in_batches,
    load_projection_file,
    network_outputs_at_projection_step,
)
from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.hashing import hash_file
from gance_tpu_torch.utils.logging import LOGGER


def _resize(image: np.ndarray, side: int) -> np.ndarray:
    import cv2

    return cv2.resize(image, (side, side))


def final_latents_frames(reader, video_height: int = 400) -> Iterator[np.ndarray]:
    """Per frame of `reader`: [scatter of the final latent rows | target image |
    final image], each `video_height` square."""
    from gance_tpu_torch.viz.panels import vector_visualizer

    render = vector_visualizer(
        y_range=(-12.0, 12.0),
        title="final latents",
        output_width=video_height,
        output_height=video_height,
    )
    for latents, target, final in zip(
        reader.final_latents, reader.target_images, reader.final_images
    ):
        yield horizontal_concat_images(
            [render(latents), _resize(target, video_height), _resize(final, video_height)]
        )


def visualize_final_latents(
    projection_file_path: Path,
    output_video_path: Path,
    audio_paths: Optional[List[Path]] = None,
    video_height: int = 400,
    video_fps: Optional[float] = None,
) -> None:
    """
    Per frame: [scatter of the final latent rows | target image | final image]
    hconcat video (reference :214-267).
    """
    with load_projection_file(projection_file_path) as reader:
        attrs = reader.projection_attributes
        write_source_to_disk_consume(
            source=final_latents_frames(reader, video_height),
            video_path=output_video_path,
            video_fps=video_fps or attrs.projection_fps or 30.0,
            audio_paths=audio_paths,
        )


def convergence_curves(reader, consider_first_n_frames: Optional[int] = None) -> List[np.ndarray]:
    """`projection_convergence` over an open reader."""
    if not reader.projection_attributes.latents_histories_enabled:
        raise ValueError("Projection file has no latent histories to analyze.")
    out: List[np.ndarray] = []
    for final, history in itertools.islice(
        zip(reader.final_latents, reader.latents_histories), consider_first_n_frames
    ):
        out.append(np.array([np.abs(step - final).sum() for step in history]))
    if not out:
        raise ValueError("Projection file has no frames to analyze.")
    return out


def projection_convergence(
    projection_file_path: Path,
    consider_first_n_frames: Optional[int] = None,
) -> List[np.ndarray]:
    """
    Per-frame L1 distance of each history latent to the final latent: the
    signal behind the reference's "how many steps are enough" analysis (:59-211).
    :return: one distance-per-step array per frame.
    """
    with load_projection_file(projection_file_path) as reader:
        return convergence_curves(reader, consider_first_n_frames)


def percent_projected_steps(
    curves: List[np.ndarray], percent_projected: float = 0.8
) -> List[int]:
    """
    For each convergence curve, the first step at which `percent_projected` of the
    total distance drop has been covered: the heuristic the reference used to pick
    production step counts (CHANGELOG 0.14.0).
    """
    steps = []
    for distances in curves:
        total_drop = distances[0] - distances.min()
        if total_drop > 0:
            covered = (distances[0] - distances) / total_drop
            steps.append(int(np.argmax(covered >= percent_projected)))
        else:
            steps.append(0)
    return steps


def _smoothed_derivative_curves(
    curves: List[np.ndarray], order: int
) -> List[np.ndarray]:
    """Smoothing-spline nth derivatives of each curve, sampled at every step."""
    from scipy.interpolate import UnivariateSpline

    out = []
    for distances in curves:
        steps = len(distances)
        x = np.arange(steps, dtype=np.float64)
        degree = min(3, steps - 1)  # splines need m > k points
        if degree < order:
            out.append(np.zeros(steps))
            continue
        smoothing = 5.0 if steps >= 5 else float(max(steps - 1, 0))
        spline = UnivariateSpline(x=x, y=distances, k=degree, s=smoothing)
        out.append(spline.derivative(n=order)(x))
    return out


def visualize_projection_convergence(
    projection_file_path: Path,
    output_image_path: Path,
    percent_projected: float = 0.8,
    consider_first_n_frames: Optional[int] = None,
) -> None:
    """
    Three stacked panels: raw per-frame convergence curves, smoothing-spline 1st
    derivatives (slope), and 2nd derivatives (curvature), with vertical markers at
    each frame's percent-projected step and at the mean / mean-1std / mean-2std
    steps (reference :59-211, the analysis that chose production step counts).
    """
    import matplotlib.pyplot as plt

    curves = projection_convergence(projection_file_path, consider_first_n_frames)
    poi = percent_projected_steps(curves, percent_projected)
    mean_step = int(np.mean(poi))
    std_step = int(np.std(poi))

    first_derivs = _smoothed_derivative_curves(curves, 1)
    second_derivs = _smoothed_derivative_curves(curves, 2)

    figure, axes = plt.subplots(
        3, 1, figsize=(12, 12), dpi=100, sharex=True
    )
    figure.suptitle(
        f"File: {Path(projection_file_path).name}\n"
        f"Average {percent_projected:.0%} projection step: {mean_step}"
    )
    panels = [
        ("L1 distance to final latent", curves, False),
        ("1st derivative (slope)", first_derivs, True),
        ("2nd derivative (curvature)", second_derivs, True),
    ]
    for axis, (title, lines, clip_outliers) in zip(axes, panels):
        stacked = np.concatenate(lines)
        if clip_outliers:
            # derivative splines can spike at the ends; show mean +- 5 std
            center, bound = stacked.mean(), stacked.std() * 5
            if bound == 0.0:  # constant curves: keep the ylim non-singular
                bound = max(abs(float(center)), 1.0) * 1e-3
            y_lo, y_hi = center - bound, center + bound
            axis.set_ylim(y_lo, y_hi)
        else:
            y_lo, y_hi = float(stacked.min()), float(stacked.max())
        for line in lines:
            axis.plot(line, linewidth=1, alpha=0.5)
        axis.vlines(poi, y_lo, y_hi, color="grey", linestyles="dotted", alpha=0.5,
                    label=f"frame {percent_projected:.0%} projected")
        axis.vlines([mean_step], y_lo, y_hi, color="black",
                    label=f"mean ({mean_step})")
        axis.vlines([mean_step - std_step], y_lo, y_hi, color="blue",
                    label=f"mean - 1 std ({mean_step - std_step})")
        axis.vlines([mean_step - 2 * std_step], y_lo, y_hi, color="purple",
                    label=f"mean - 2 std ({mean_step - 2 * std_step})")
        axis.set_title(title, fontsize=9)
        axis.grid(True, alpha=0.3)
    axes[-1].set_xlabel("projection step")
    axes[-1].legend(fontsize=6)
    figure.savefig(str(output_image_path))
    plt.close(figure)
    LOGGER.info("Wrote convergence analysis to %s", output_image_path)


def projection_history_frames(reader, network: "object", steps_stride: int = 1
                              ) -> Iterator[np.ndarray]:
    """
    Per frame of `reader`, per `steps_stride`-th step of its latent history:
    [target | the step's latents synthesized through `network`], both at the
    network's resolution.
    """
    side = network.resolution

    def steps():
        for target, history in zip(reader.target_images, reader.latents_histories):
            target_tile = _resize(target, side)
            for step_index, latents in enumerate(history):
                if step_index % steps_stride == 0:
                    yield target_tile, latents

    tiles, latents = tee(steps())
    images = images_in_batches(network, (step_latents for _, step_latents in latents))
    for (target_tile, _), image in zip(tiles, images):
        yield horizontal_concat_images([target_tile, image])


def partial_projection_history_frames(reader, network: "object", step: int
                                      ) -> Iterator[np.ndarray]:
    """Per frame of `reader`: [target | its history's latents at `step`
    synthesized through `network`]."""
    side = network.resolution
    for target, image in zip(reader.target_images,
                             network_outputs_at_projection_step(reader, network, step)):
        yield horizontal_concat_images([_resize(target, side), image])


def _load_checked_network(reader, network_path: Path, network_not_matching_ok: bool,
                          device: Device):
    """The network of `network_path` on `device`, after checking its md5
    against the file's attributes unless `network_not_matching_ok`."""
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    attrs = reader.projection_attributes
    actual_hash = hash_file(Path(network_path))
    if actual_hash != attrs.network_md5_hash and not network_not_matching_ok:
        raise ValueError(
            f"Network hash {actual_hash} != projection file's "
            f"{attrs.network_md5_hash}; pass network_not_matching_ok to override."
        )
    return SynthesisNetwork.from_pkl(Path(network_path), device=device)


def visualize_projection_history(
    projection_file_path: Path,
    output_video_path: Path,
    network_path: Path,
    network_not_matching_ok: bool = False,
    video_fps: float = 30.0,
    steps_stride: int = 1,
    device: Device = "cuda",
) -> None:
    """
    Re-synthesize every latent-history step through a network next to the target
    (reference :308-381; verifies the network md5 against the file attrs unless
    `network_not_matching_ok`).
    """
    device = resolve_device(device)
    with load_projection_file(projection_file_path) as reader:
        network = _load_checked_network(reader, network_path, network_not_matching_ok, device)
        write_source_to_disk_consume(
            source=projection_history_frames(reader, network, steps_stride),
            video_path=output_video_path,
            video_fps=video_fps,
        )


def visualize_partial_projection_history(
    projection_file_path: Path,
    output_video_path: Path,
    network_path: Path,
    step: int,
    network_not_matching_ok: bool = False,
    video_fps: float = 30.0,
    device: Device = "cuda",
) -> None:
    """
    Re-synthesize a single chosen history step across all frames next to the
    targets (reference :384-451).
    """
    device = resolve_device(device)
    with load_projection_file(projection_file_path) as reader:
        network = _load_checked_network(reader, network_path, network_not_matching_ok, device)
        write_source_to_disk_consume(
            source=partial_projection_history_frames(reader, network, step),
            video_path=output_video_path,
            video_fps=video_fps,
        )
