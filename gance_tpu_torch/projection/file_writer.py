"""
Projection-file (HDF5 v2) writer and the video -> projection-file pipeline:
the port's copy of the writer classes of gance_tpu/projection/file_writer.py,
with h5py imported where it is used, and `project_video_to_file`, which
projects a video's frames with the port's `Projector` on one device.

Schema, as the JAX package and the reference write it:
  * root attrs = ProjectionAttributes (complete=False until the end: a crash
    keeps every finished frame);
  * per-frame datasets  /target_images/target_images_{i},
                        /final_latents/final_latents_{i}   (shape (1, R, 512)),
                        /final_images/final_images_{i};
  * per-frame history groups /latents_histories/latents_histories_{i}/
    latents_histories_{i}_step_{s} (same pattern for images/noises);
  * every dataset gzip level 9 + shuffle;
  * f.flush() after every frame.

Each history payload goes to its correctly-named group (the reference swaps
images and noises; file_reader.py detects and unswaps that layout).
"""

import itertools
import os
from contextlib import contextmanager
from pathlib import Path
from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np
import torch

from gance_tpu_torch.projection.projection_types import (
    FINAL_IMAGE_GROUP_NAME,
    FINAL_LATENTS_GROUP_NAME,
    IMAGES_HISTORIES_GROUP_NAME,
    LATENTS_HISTORIES_GROUP_NAME,
    LATEST_VERSION,
    NOISES_HISTORIES_GROUP_NAME,
    TARGET_IMAGES_GROUP_NAME,
    CompleteLatentsType,
    NoisesShapesType,
    ProjectionAttributes,
)
from gance_tpu_torch.utils.logging import LOGGER

if TYPE_CHECKING:
    import h5py

DEFAULT_STEPS_PER_PROJECTION = 1000
DEFAULT_EXPECTED_TIME_PER_STEP = 60.0
COMPRESSION_LEVEL = 9

_PER_FRAME_DATASET_GROUP_NAMES = [
    TARGET_IMAGES_GROUP_NAME,
    FINAL_LATENTS_GROUP_NAME,
    FINAL_IMAGE_GROUP_NAME,
]
_PER_FRAME_SUB_GROUP_GROUP_NAMES = [
    LATENTS_HISTORIES_GROUP_NAME,
    IMAGES_HISTORIES_GROUP_NAME,
    NOISES_HISTORIES_GROUP_NAME,
]


def flatten_noises(noises: List[np.ndarray]) -> np.ndarray:
    """Concat-flatten the (inconsistently shaped) noise buffers."""
    return np.concatenate([np.asarray(n).flatten() for n in noises])


def _write_dataset(group: "h5py.Group", name: str, data: np.ndarray) -> None:
    group.create_dataset(
        name,
        shape=np.asarray(data).shape,
        dtype=np.asarray(data).dtype,
        data=data,
        compression="gzip",
        compression_opts=COMPRESSION_LEVEL,
        shuffle=True,
    )


class ProjectionFileWriter:
    """
    Incremental projection-file writer with the reference's durability semantics.

    Usage:
        with ProjectionFileWriter(path, attrs) as writer:
            with writer.frame_writer() as frame:
                frame.record_step(step, latents, noises, image)   # per history step
                frame.finish(target_image, final_latents, final_image)
        # on clean exit the `complete` attr flips to True
    """

    def __init__(self, path: Path, attributes: ProjectionAttributes) -> None:
        import h5py

        self._path = Path(path)
        self.attributes = attributes
        self._file = h5py.File(str(self._path), "w")
        self.attributes.complete = False
        self._file.attrs.update(self.attributes.to_attrs_dict())
        self._groups = {
            name: self._file.create_group(name)
            for name in _PER_FRAME_DATASET_GROUP_NAMES + _PER_FRAME_SUB_GROUP_GROUP_NAMES
        }
        self._frame_index = 0
        self._noises_shapes: Optional[NoisesShapesType] = None

    def __enter__(self) -> "ProjectionFileWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(complete=exc_type is None)

    @property
    def frame_index(self) -> int:
        return self._frame_index

    @contextmanager
    def frame_writer(self):
        """Context for writing one frame's history steps + final datasets."""
        writer = _FrameWriter(self, self._frame_index)
        yield writer
        if not writer.finished:
            raise ValueError("frame_writer exited without calling finish()")
        self._frame_index += 1
        self._file.flush()

    @contextmanager
    def batch_frame_writers(self, count: int):
        """
        Contexts for `count` consecutive frames written together (batched
        projection): each frame keeps its own per-frame groups/datasets, so the
        on-disk schema is identical to sequential writing.
        """
        writers = [_FrameWriter(self, self._frame_index + i) for i in range(count)]
        yield writers
        for writer in writers:
            if not writer.finished:
                raise ValueError("batch_frame_writers exited with unfinished frames")
        self._frame_index += count
        self._file.flush()

    def record_noises_shapes(self, shapes: NoisesShapesType) -> None:
        if self._noises_shapes is None:
            self._noises_shapes = list(shapes)
        elif list(shapes) != list(self._noises_shapes):
            LOGGER.warning(
                "Noises shapes changed between projections. Was %s now %s",
                self._noises_shapes,
                shapes,
            )

    def close(self, complete: bool) -> None:
        if self._file is None:
            return
        self.attributes.complete = complete
        self.attributes.projection_frame_count = self._frame_index
        if self._noises_shapes:
            self.attributes.noises_shapes = self._noises_shapes
        self._file.attrs.update(self.attributes.to_attrs_dict())
        self._file.close()
        self._file = None


class _FrameWriter:
    """Writes one frame's step history + final datasets (internal)."""

    def __init__(self, parent: ProjectionFileWriter, index: int) -> None:
        self._parent = parent
        self._index = index
        self.finished = False
        attrs = parent.attributes
        self._history_groups = {}
        for name, enabled in [
            (LATENTS_HISTORIES_GROUP_NAME, attrs.latents_histories_enabled),
            (IMAGES_HISTORIES_GROUP_NAME, attrs.images_histories_enabled),
            (NOISES_HISTORIES_GROUP_NAME, attrs.noises_histories_enabled),
        ]:
            self._history_groups[name] = (
                parent._groups[name].create_group(f"{name}_{index}") if enabled else None
            )

    def record_step(
        self,
        step: int,
        latents: CompleteLatentsType,
        noises: List[np.ndarray],
        image: np.ndarray,
    ) -> None:
        """Append one optimization step's intermediates to the enabled histories."""
        # Payloads are built lazily per enabled group: flatten_noises alone is
        # ~11 MB of host concat per step per frame at 1024px, and noise
        # histories are off by default.
        payloads = {
            LATENTS_HISTORIES_GROUP_NAME: lambda: np.asarray(latents),
            IMAGES_HISTORIES_GROUP_NAME: lambda: np.asarray(image),
            NOISES_HISTORIES_GROUP_NAME: lambda: (
                flatten_noises(noises) if noises else None
            ),
        }
        for name, group in self._history_groups.items():
            if group is None:
                continue
            payload = payloads[name]()
            if payload is not None:
                _write_dataset(group, f"{name}_{self._index}_step_{step}", payload)
        if noises:
            self._parent.record_noises_shapes([tuple(np.asarray(n).shape) for n in noises])

    def finish(
        self,
        target_image: np.ndarray,
        final_latents: CompleteLatentsType,
        final_image: np.ndarray,
    ) -> None:
        """Write the three per-frame final datasets."""
        groups = self._parent._groups
        _write_dataset(
            groups[TARGET_IMAGES_GROUP_NAME],
            f"{TARGET_IMAGES_GROUP_NAME}_{self._index}",
            np.asarray(target_image),
        )
        _write_dataset(
            groups[FINAL_LATENTS_GROUP_NAME],
            f"{FINAL_LATENTS_GROUP_NAME}_{self._index}",
            np.asarray(final_latents),
        )
        _write_dataset(
            groups[FINAL_IMAGE_GROUP_NAME],
            f"{FINAL_IMAGE_GROUP_NAME}_{self._index}",
            np.asarray(final_image),
        )
        self.finished = True


class _NullFrameWriter:
    """record_step/finish surface of _FrameWriter, writing nothing."""

    def __init__(self) -> None:
        self.finished = False

    def record_step(self, step, latents, noises, image) -> None:  # noqa: D102
        pass

    def finish(self, target_image, final_latents, final_image) -> None:  # noqa: D102
        self.finished = True


class NullProjectionFileWriter:
    """
    Same surface as ProjectionFileWriter, writes nothing: the stand-in for the
    processes of a multi-process projection that do not own the file.
    """

    def __init__(self, path: Path, attributes: ProjectionAttributes) -> None:
        self.attributes = attributes
        self._frame_index = 0

    def __enter__(self) -> "NullProjectionFileWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    @property
    def frame_index(self) -> int:
        return self._frame_index

    @contextmanager
    def frame_writer(self):
        writer = _NullFrameWriter()
        yield writer
        self._frame_index += 1

    @contextmanager
    def batch_frame_writers(self, count: int):
        yield [_NullFrameWriter() for _ in range(count)]
        self._frame_index += count

    def record_noises_shapes(self, shapes: NoisesShapesType) -> None:
        pass

    def close(self, complete: bool) -> None:
        pass


def project_video_to_file(
    path_to_video: Path,
    path_to_network: Path,
    projection_file_path: Path,
    video_fps: Optional[float] = None,
    projection_fps: Optional[float] = None,
    projection_width_height: Optional[Tuple[int, int]] = None,
    steps_per_projection: int = DEFAULT_STEPS_PER_PROJECTION,
    num_frames_to_project: Optional[int] = None,
    latents_histories_enabled: bool = True,
    noises_histories_enabled: bool = False,
    images_histories_enabled: bool = False,
    batch_number: Optional[int] = None,
    expected_time_per_step: float = DEFAULT_EXPECTED_TIME_PER_STEP,
    compute_dtype: Optional[str] = None,
    projection_batch: int = 1,
    mesh: Optional[object] = None,
    vgg_weights_path: Optional[Path] = None,
    warm_start: bool = False,
    convergence_stop: Optional[float] = None,
    convergence_window: Optional[int] = None,
    convergence_min_steps: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> None:
    """
    Project every frame of a video into a network's latent space, streaming results
    into a projection file (reference projector_file_writer.py:617-802), on
    `device`, or data-parallel over `mesh` (the projection batch is raised to
    fill its data axis). In a group of several processes every process runs
    the same loop, only process 0 writes the file (the others drive the
    null writer), and a process that fails exits at once so that its peers
    fail in their next collective instead of hanging there.

    :param vgg_weights_path: pretrained perceptual weights — the NVlabs
        `vgg16_zhang_perceptual.pkl` or an imported `.npz`; None selects the
        deterministic random-VGG fallback metric.
    :param warm_start: initialize each batch's latents from the previous
        batch's final latents (jitter-free) instead of the dlatent average
        (the reference always cold-starts every frame). The first batch still
        cold-starts.
    :param convergence_stop: opt-in early stop — end a batch's optimization
        once every frame's distance trace plateaus (relative improvement
        between the two most recent `convergence_window`-step median blocks
        below this value). See ProjectorSettings.convergence_stop. The file's
        `steps_in_projection` attr keeps the configured maximum; the per-frame
        history group lengths record the steps actually run.
    """
    from gance_tpu_torch.media.video import frames_in_video
    from gance_tpu_torch.projection.projector import Projector, ProjectorSettings
    from gance_tpu_torch.utils.hashing import hash_file

    from gance_tpu_torch.parallel.mesh import data_axis_size, process_group_info

    video = frames_in_video(
        video_path=path_to_video,
        video_fps=video_fps,
        reduce_fps_to=projection_fps,
        width_height=projection_width_height,
    )

    if projection_width_height is None:
        projection_width_height = tuple(video.original_resolution)

    # Reference derivation (projector_file_writer.py:669-690): originals describe
    # the source file; the projection count reflects the fps downsample.
    true_projection_fps = (
        video.original_fps if projection_fps is None else projection_fps
    )
    if num_frames_to_project is not None:
        num_projection_frames = num_frames_to_project
    else:
        num_projection_frames = video.effective_frame_count

    data_axis = data_axis_size(mesh)
    if projection_batch < data_axis:
        # Frames are independent: fill the data axis with frames rather than
        # pad every batch with discarded copies of the last one.
        LOGGER.info("Raising projection batch %d -> %d to fill the mesh data axis.",
                    projection_batch, data_axis)
        projection_batch = data_axis

    settings = ProjectorSettings(num_steps=steps_per_projection)
    if compute_dtype is not None:
        settings.compute_dtype = compute_dtype
    if convergence_stop is not None:
        settings.convergence_stop = convergence_stop
    if convergence_window is not None:
        settings.convergence_window = convergence_window
    if convergence_min_steps is not None:
        settings.convergence_min_steps = convergence_min_steps
    projector = Projector.from_pkl(
        path_to_network,
        expected_time_per_step=expected_time_per_step,
        settings=settings,
        mesh=mesh,
        vgg_weights_path=vgg_weights_path,
        device=device,
    )

    attributes = ProjectionAttributes(
        version_number=LATEST_VERSION,
        complete=False,
        original_target_path=str(path_to_video),
        original_width_height=tuple(video.original_resolution),
        projection_width_height=tuple(projection_width_height),
        target_md5_hash=hash_file(Path(path_to_video)),
        original_network_path=str(path_to_network),
        network_md5_hash=hash_file(Path(path_to_network)),
        steps_in_projection=steps_per_projection,
        noises_shapes=np.nan,
        latents_histories_enabled=latents_histories_enabled,
        noises_histories_enabled=noises_histories_enabled,
        images_histories_enabled=images_histories_enabled,
        original_fps=video.original_fps,
        projection_fps=true_projection_fps,
        original_frame_count=video.total_frame_count,
        projection_frame_count=num_projection_frames,
    )

    any_histories = (
        latents_histories_enabled
        or noises_histories_enabled
        or images_histories_enabled
    )
    frames_iterator = itertools.islice(video.frames, num_frames_to_project)
    process_index, process_count = process_group_info()
    writer_factory = ProjectionFileWriter if process_index == 0 else NullProjectionFileWriter
    try:
        _projection_write_loop(
            writer_factory, projection_file_path, attributes, frames_iterator,
            projection_batch, projector, batch_number, num_projection_frames,
            any_histories, images_histories_enabled, noises_histories_enabled,
            warm_start,
        )
    except BaseException:
        if process_count > 1:
            LOGGER.exception(
                "Projection failed on process %d of %d; exiting so that peer processes "
                "abort instead of hanging in collectives.", process_index, process_count,
            )
            # os._exit, not sys.exit or destroy_process_group: both wait on
            # peers that sit in a collective. The dead process's closed
            # sockets fail the peers' next collective.
            os._exit(1)
        raise
    LOGGER.info("Projection totally complete!")


def _projection_write_loop(
    writer_factory,
    projection_file_path: Path,
    attributes: ProjectionAttributes,
    frames_iterator,
    projection_batch: int,
    projector,
    batch_number: Optional[int],
    num_projection_frames: int,
    any_histories: bool,
    images_histories_enabled: bool,
    noises_histories_enabled: bool,
    warm_start: bool,
) -> None:
    """The per-batch project -> write loop of project_video_to_file:
    `writer_factory(path, attributes)` is a context manager with the
    ProjectionFileWriter surface (the seam an in-memory writer takes)."""
    previous_finals = None
    with writer_factory(projection_file_path, attributes) as writer:
        while True:
            chunk = list(itertools.islice(frames_iterator, max(projection_batch, 1)))
            if not chunk:
                break
            LOGGER.info(
                "Rendering projection %s%d..%d/%d",
                f"batch {batch_number} - " if batch_number is not None else "",
                writer.frame_index,
                writer.frame_index + len(chunk) - 1,
                num_projection_frames,
            )
            with writer.batch_frame_writers(len(chunk)) as frame_writers:

                def record_batch_step(step, latents, noises, images):
                    for i, frame_writer in enumerate(frame_writers):
                        frame_writer.record_step(
                            step,
                            latents[i : i + 1],
                            [n[i : i + 1] for n in noises],
                            images[i] if images.size else images[0:0],
                        )

                initial_latents = None
                warmed = warm_start and previous_finals is not None
                if warmed:
                    # every frame of the new batch starts at the last finished
                    # frame's final w (row 0; rows are identical by invariant)
                    initial_latents = np.tile(previous_finals[0], (len(chunk), 1))
                results = projector.project_batch(
                    np.stack(chunk),
                    step_callback=record_batch_step if any_histories else None,
                    want_step_images=images_histories_enabled,
                    # Latents histories alone fetch once per segment; noise or
                    # image histories need a fetch every step.
                    per_step_noises=noises_histories_enabled,
                    initial_latents=initial_latents,
                    # the annealed exploration jitter exists to escape the cold
                    # dlatent-average start; warmed batches run jitter-free
                    noise_factor=0.0 if warmed else None,
                )
                if warm_start:
                    previous_finals = results[-1].final_latents[0]
                for frame, frame_writer, result in zip(chunk, frame_writers, results):
                    writer.record_noises_shapes(result.noises_shapes)
                    frame_writer.finish(
                        target_image=frame,
                        final_latents=result.final_latents,
                        final_image=result.final_image,
                    )
