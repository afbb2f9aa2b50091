"""
Projection-file (HDF5 v2) writer: the port's copy of the writer classes of
gance_tpu/projection/file_writer.py, with h5py imported where it is used.
`project_video_to_file` waits for the projector (ROADMAP.md Queue 1 item 7).

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

from contextlib import contextmanager
from pathlib import Path
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from gance_tpu_torch.projection.projection_types import (
    FINAL_IMAGE_GROUP_NAME,
    FINAL_LATENTS_GROUP_NAME,
    IMAGES_HISTORIES_GROUP_NAME,
    LATENTS_HISTORIES_GROUP_NAME,
    NOISES_HISTORIES_GROUP_NAME,
    TARGET_IMAGES_GROUP_NAME,
    CompleteLatentsType,
    NoisesShapesType,
    ProjectionAttributes,
)
from gance_tpu_torch.utils.logging import LOGGER

if TYPE_CHECKING:
    import h5py

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
