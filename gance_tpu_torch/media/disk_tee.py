"""
Disk-backed iterator tee (the port's copy of gance_tpu/media/disk_tee.py,
which holds no JAX; h5py is imported only by the HDF5 serializer).

`itertools.tee` holds un-consumed items in RAM; for frame streams that's gigabytes.
This version serializes each primary item to a temp file per secondary copy;
secondaries deserialize+delete lazily. Serializers: pickle (default) and HDF5
(gzip+shuffle — matching the projection-file dataset settings) for ndarray frames.
"""

import pickle
import tempfile
from collections import deque
from pathlib import Path
from typing import Any, Callable, Deque, Iterator, NamedTuple, Tuple

import numpy as np


class Serializer(NamedTuple):
    """A store/load pair over temp files."""

    store: Callable[[Any, Path], None]
    load: Callable[[Path], Any]


def _pickle_store(item: Any, path: Path) -> None:
    with open(str(path), "wb") as f:
        pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)


def _pickle_load(path: Path) -> Any:
    with open(str(path), "rb") as f:
        return pickle.load(f)


PICKLE_SERIALIZER = Serializer(store=_pickle_store, load=_pickle_load)


def _hdf5_store(item: np.ndarray, path: Path) -> None:
    import h5py

    with h5py.File(str(path), "w") as f:
        f.create_dataset(
            "item", data=np.asarray(item), compression="gzip",
            compression_opts=9, shuffle=True,
        )


def _hdf5_load(path: Path) -> np.ndarray:
    import h5py

    with h5py.File(str(path), "r") as f:
        return f["item"][:]


HDF5_SERIALIZER = Serializer(store=_hdf5_store, load=_hdf5_load)


def _npy_store(item: np.ndarray, path: Path) -> None:
    with open(str(path), "wb") as f:
        np.save(f, np.asarray(item), allow_pickle=False)


def _npy_load(path: Path) -> np.ndarray:
    with open(str(path), "rb") as f:
        return np.load(f, allow_pickle=False)


# The tee's files are process-lifetime scratch, not archival data, so the
# serializer should cost I/O, not CPU: gzip-9 HDF5 spends seconds of one host
# core per 1024px frame, a raw .npy writes 3.2 MB. HDF5_SERIALIZER remains
# available for disk-constrained runs (its settings match the projection-file
# datasets).
NPY_SERIALIZER = Serializer(store=_npy_store, load=_npy_load)


def iterator_on_disk(
    iterator: Iterator[Any], copies: int = 1, serializer: Serializer = PICKLE_SERIALIZER
) -> Tuple[Iterator[Any], ...]:
    """
    Tee `iterator` into (primary, *copies secondaries) with disk spill instead of
    RAM. The primary serializes each item once per secondary as it is consumed;
    each secondary deserializes (and deletes) lazily in order.

    The temp directory is made at the first item stored and removed once every
    stream has ended or been closed (close the ones a consumer stops reading:
    `zip` stops one short of a peer's end). JAX's copy removes it only when
    every secondary reads past its end, so a render whose copies are read by
    `zip`, or not read at all, leaves its directory behind.
    """
    import shutil

    queues: Tuple[Deque[Path], ...] = tuple(deque() for _ in range(copies))
    state = {"primary_exhausted": False, "open": copies + 1, "dir": None, "n": 0}

    def _store(item: Any, index: int) -> Path:
        if state["dir"] is None:
            state["dir"] = Path(tempfile.mkdtemp(prefix="gance_tpu_torch_tee_"))
        path = state["dir"] / f"item_{state['n']}_{index}"
        serializer.store(item, path)
        return path

    def _finished() -> None:
        state["open"] -= 1
        if state["open"] == 0 and state["dir"] is not None:
            shutil.rmtree(state["dir"], ignore_errors=True)

    def primary() -> Iterator[Any]:
        try:
            for item in iterator:
                for qi, queue in enumerate(queues):
                    queue.append(_store(item, qi))
                state["n"] += 1
                yield item
            state["primary_exhausted"] = True
        finally:
            _finished()

    def secondary(queue: Deque[Path]) -> Iterator[Any]:
        try:
            while True:
                if queue:
                    path = queue.popleft()
                    item = serializer.load(path)
                    path.unlink(missing_ok=True)
                    yield item
                elif state["primary_exhausted"]:
                    return
                else:
                    raise RuntimeError(
                        "Disk-tee secondary consumed ahead of the primary iterator; "
                        "drive the primary first (it is the producer)."
                    )
        finally:
            _finished()

    return (primary(),) + tuple(secondary(q) for q in queues)
