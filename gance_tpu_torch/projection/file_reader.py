"""
Streaming projection-file reader (the port's copy of
gance_tpu/projection/file_reader.py, with h5py imported where it is used, so
that the module imports on a host without it).

Ordering contract: groups and datasets are read in the order of the trailing
`_<int>` of their names, not lexicographically (the reference's CHANGELOG
0.13.0 fix), and one member is open at a time.

Reference-layout compat: the reference writer stores flattened noises under
`images_histories` and images under `noises_histories`. The reader detects
that layout by payload shape (images are 3-D uint8, flattened noises 1-D
float) and unswaps on read, so files of either writer read back alike.
"""

from contextlib import contextmanager
from pathlib import Path
from typing import TYPE_CHECKING, Iterator, Optional

import numpy as np

from gance_tpu_torch.projection.projection_types import (
    FINAL_IMAGE_GROUP_NAME,
    FINAL_LATENTS_GROUP_NAME,
    IMAGES_HISTORIES_GROUP_NAME,
    LATENTS_HISTORIES_GROUP_NAME,
    NOISES_HISTORIES_GROUP_NAME,
    TARGET_IMAGES_GROUP_NAME,
    ProjectionAttributes,
    complete_latents_to_matrix,
)
from gance_tpu_torch.types import MatricesLabel
from gance_tpu_torch.utils.logging import LOGGER

if TYPE_CHECKING:
    import h5py


def _sorted_items(group: "h5py.Group", h5_type) -> Iterator:
    """Items of a type, ordered by the trailing _<int> of their names.

    Opens ONE member at a time: holding every member open keeps each gzip
    dataset's decompressed chunk cache alive for the whole sweep, an O(file)
    growth over an album-length projection file. Sorting needs only the
    names."""
    names = [
        name
        for name in group.keys()
        if group.get(name, getclass=True) is h5_type
    ]
    for name in sorted(names, key=lambda n: int(n.split("_")[-1])):
        yield group[name]


def _datasets_in_group(group: "h5py.Group", inner_matrix: bool) -> Iterator[np.ndarray]:
    import h5py

    for dataset in _sorted_items(group, h5py.Dataset):
        array = np.array(dataset)
        yield complete_latents_to_matrix(array) if inner_matrix else array


def _double_iter(group: "h5py.Group", inner_matrix: bool) -> Iterator[Iterator[np.ndarray]]:
    import h5py

    for sub in _sorted_items(group, h5py.Group):
        yield _datasets_in_group(sub, inner_matrix=inner_matrix)


class ProjectionFileReader:
    """Read-only view over a projection file; all iterators are lazy."""

    def __init__(self, projection_file_path: Path) -> None:
        import h5py

        self._file = h5py.File(str(projection_file_path), "r")
        self.projection_attributes = ProjectionAttributes.from_attrs_dict(
            dict(self._file.attrs)
        )
        self._histories_swapped: Optional[bool] = None

    def close(self) -> None:
        self._file.close()

    @property
    def histories_swapped(self) -> bool:
        """
        True when this file was written with the reference's swapped image/noise
        history layout (see module docstring); detected from payload shapes.
        """
        if self._histories_swapped is None:
            self._histories_swapped = self._detect_swapped_histories()
        return self._histories_swapped

    def _detect_swapped_histories(self) -> bool:
        """
        Peek at one step dataset: a 1-D float payload under `images_histories`
        (or a 3-D uint8 payload under `noises_histories`) is the reference's
        swapped layout; the converse is ours. Empty/absent groups -> not swapped.
        """
        import h5py

        for group_name, expect_images in (
            (IMAGES_HISTORIES_GROUP_NAME, True),
            (NOISES_HISTORIES_GROUP_NAME, False),
        ):
            group = self._file.get(group_name)
            if group is None:
                continue
            for per_frame in group.values():
                if not isinstance(per_frame, h5py.Group):
                    continue
                for dataset in per_frame.values():
                    looks_like_images = (
                        dataset.ndim == 3 and dataset.dtype == np.uint8
                    )
                    looks_like_noises = dataset.ndim == 1 and np.issubdtype(
                        dataset.dtype, np.floating
                    )
                    if looks_like_images or looks_like_noises:
                        swapped = looks_like_images != expect_images
                        if swapped:
                            LOGGER.warning(
                                "Projection file has the reference's swapped "
                                "images/noises history layout; unswapping on read."
                            )
                        return swapped
        return False

    def _history_group(self, name: str) -> "h5py.Group":
        """Resolve a history group name through the reference-layout unswap."""
        if name in (IMAGES_HISTORIES_GROUP_NAME, NOISES_HISTORIES_GROUP_NAME):
            if self.histories_swapped:
                name = (
                    NOISES_HISTORIES_GROUP_NAME
                    if name == IMAGES_HISTORIES_GROUP_NAME
                    else IMAGES_HISTORIES_GROUP_NAME
                )
        return self._file[name]

    @property
    def target_images(self) -> Iterator[np.ndarray]:
        """The original frames that were projected (a fresh lazy iterator per access)."""
        return _datasets_in_group(self._file[TARGET_IMAGES_GROUP_NAME], inner_matrix=False)

    @property
    def final_latents(self) -> Iterator[np.ndarray]:
        """Final (R, 512) latents per frame (inner matrix pulled from (1, R, 512))."""
        return _datasets_in_group(self._file[FINAL_LATENTS_GROUP_NAME], inner_matrix=True)

    @property
    def final_images(self) -> Iterator[np.ndarray]:
        """The synthesized images at the final latents."""
        return _datasets_in_group(self._file[FINAL_IMAGE_GROUP_NAME], inner_matrix=False)

    @property
    def latents_histories(self) -> Iterator[Iterator[np.ndarray]]:
        return _double_iter(self._file[LATENTS_HISTORIES_GROUP_NAME], inner_matrix=True)

    @property
    def noises_histories(self) -> Iterator[Iterator[np.ndarray]]:
        return _double_iter(
            self._history_group(NOISES_HISTORIES_GROUP_NAME), inner_matrix=False
        )

    @property
    def images_histories(self) -> Iterator[Iterator[np.ndarray]]:
        return _double_iter(
            self._history_group(IMAGES_HISTORIES_GROUP_NAME), inner_matrix=False
        )

    def final_latents_at_frame(self, frame_index: int) -> np.ndarray:
        """Random access into the final latents."""
        dataset = self._file[FINAL_LATENTS_GROUP_NAME][
            f"{FINAL_LATENTS_GROUP_NAME}_{frame_index}"
        ]
        return complete_latents_to_matrix(np.array(dataset))


@contextmanager
def load_projection_file(projection_file_path: Path) -> Iterator[ProjectionFileReader]:
    """Context-managed reader."""
    reader = ProjectionFileReader(projection_file_path)
    try:
        yield reader
    finally:
        reader.close()


def verify_projection_file_assumptions(projection_file_path: Path) -> None:
    """
    Check the rows-identical invariant of projector outputs: every final
    latent's rows are equal (the projector optimizes a single w row broadcast
    to all style rows), same for latent histories when present. Raises
    ValueError, not AssertionError, so that `python -O` keeps the check.
    """

    def verify_all_rows_same(latents: Iterator[np.ndarray]) -> None:
        for matrix in latents:
            first = matrix[0]
            for row in matrix:
                if not np.array_equal(first, row):
                    raise ValueError(
                        f"{projection_file_path}: final-latent rows differ — "
                        "the all-rows-identical invariant is broken"
                    )

    with load_projection_file(projection_file_path) as reader:
        verify_all_rows_same(reader.final_latents)
        if reader.projection_attributes.latents_histories_enabled:
            for history in reader.latents_histories:
                verify_all_rows_same(history)


def _iterator_to_matrices_label(iterator: Iterator[np.ndarray], label: str) -> MatricesLabel:
    try:
        first = next(iterator)
    except StopIteration as e:
        # ValueError, not StopIteration: PEP 479 turns a StopIteration escaping
        # a generator into RuntimeError, and an empty file must error loudly.
        raise ValueError(f"Iterator labeled: {label} was empty!") from e
    data = np.concatenate([first] + list(iterator), axis=-1)
    return MatricesLabel(data=data, vector_length=first.shape[-1], label=label)


def final_latents_matrices_label(reader: ProjectionFileReader) -> MatricesLabel:
    """All final latents concatenated along time as a MatricesLabel."""
    attrs = reader.projection_attributes
    return _iterator_to_matrices_label(
        reader.final_latents,
        label=(
            f"{Path(attrs.original_target_path).name} "
            f"proj by {Path(attrs.original_network_path).name}"
        ),
    )
