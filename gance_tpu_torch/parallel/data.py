"""
Streaming training-data loader (the port's copy of gance_tpu/parallel/data.py,
with its own `read_image`; it needs no device): constant-memory batches from an image directory
of any size, deterministic per-step sampling (so crash-resume replays the exact
batch sequence — the fork's resumable-training feature, reference CHANGELOG
0.10.0), a per-host shard hook for multi-host data parallelism, and a background
prefetch thread so JPEG/PNG decode overlaps device compute.

Sampling is stateless-with-replacement: the batch for global step s is a pure
function of (seed, s), so the only resume state is the step counter already in
the training checkpoint — no sampler state to persist, no epoch bookkeeping to
corrupt.
"""

import queue
import threading
from functools import lru_cache
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gance_tpu_torch.utils.logging import LOGGER

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")

# Decoded-image LRU budget in BYTES (an image-count default at 1024px would
# silently cost ~3.2 GB host RAM — 256 x 12.6 MB float32 — on a small TPU-VM
# host while claiming "constant memory"). The image capacity is derived from
# the resolution at construction; pass cache_images to override it directly.
_DEFAULT_CACHE_BYTES = 512 * 1024 * 1024


def read_image(image_path: Path) -> np.ndarray:
    """Read an image file to an RGB uint8 array (gance_tpu/media/images.py)."""
    from PIL import Image

    with Image.open(str(image_path)) as img:
        return np.asarray(img.convert("RGB"))


def list_image_paths(
    directory: Path, host_index: int = 0, host_count: int = 1
) -> List[Path]:
    """
    Sorted image paths, optionally sharded round-robin across hosts (each host in
    a multi-host mesh feeds its local devices from a disjoint slice).
    """
    paths = sorted(
        p for p in Path(directory).iterdir() if p.suffix.lower() in IMAGE_SUFFIXES
    )
    if host_count > 1:
        paths = paths[host_index::host_count]
    return paths


class StreamingImageDataset:
    """
    Deterministic, resumable, constant-memory batch source over an image folder.
    """

    def __init__(
        self,
        directory: Path,
        resolution: int,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        cache_images: Optional[int] = None,
    ) -> None:
        self.paths = list_image_paths(directory, host_index, host_count)
        if not self.paths:
            raise ValueError(f"No images in {directory} (host shard {host_index}/{host_count})")
        self.resolution = resolution
        self.seed = seed
        if cache_images is None:
            bytes_per_image = resolution * resolution * 3 * 4  # decoded float32
            cache_images = max(8, _DEFAULT_CACHE_BYTES // bytes_per_image)
        self._load_cached = lru_cache(maxsize=max(cache_images, 1))(self._load_image)
        LOGGER.info(
            "Streaming dataset: %d images at %dpx (host %d/%d, cache %d images)",
            len(self.paths), resolution, host_index, host_count, cache_images,
        )

    def __len__(self) -> int:
        return len(self.paths)

    def _load_image(self, index: int) -> np.ndarray:
        import cv2

        image = read_image(self.paths[index])
        image = cv2.resize(
            image, (self.resolution, self.resolution), interpolation=cv2.INTER_AREA
        )
        return image.astype(np.float32) / 127.5 - 1.0

    def indices_for_step(self, step: int, batch_size: int) -> np.ndarray:
        """The step's sample indices — a pure function of (seed, step)."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31 - 1))
        return rng.randint(0, len(self.paths), size=batch_size)

    def batch_at(self, step: int, batch_size: int) -> np.ndarray:
        """(B, R, R, 3) float32 [-1, 1] batch for a global step."""
        return np.stack(
            [self._load_cached(int(i)) for i in self.indices_for_step(step, batch_size)]
        )

    def batches(
        self,
        start_step: int,
        total_steps: int,
        batch_size: int,
        prefetch: int = 2,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """
        (step, batch) pairs for steps [start_step, total_steps), decoded on a
        background thread `prefetch` batches ahead so host IO overlaps the
        device's train step.
        """
        if start_step >= total_steps:
            return
        out: "queue.Queue[Optional[Tuple[int, np.ndarray]]]" = queue.Queue(
            maxsize=max(prefetch, 1)
        )
        error: List[BaseException] = []
        stop = threading.Event()

        def _put_or_stop(item: Optional[Tuple[int, np.ndarray]]) -> bool:
            """put() that aborts when the consumer has gone away (a producer
            blocked forever on the bounded queue would leak the thread and the
            decoded batches it holds)."""
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for step in range(start_step, total_steps):
                    if not _put_or_stop((step, self.batch_at(step, batch_size))):
                        return
            except BaseException as e:  # pragma: no cover - surfaced to consumer
                error.append(e)
            finally:
                _put_or_stop(None)

        worker = threading.Thread(target=produce, daemon=True, name="dataset-prefetch")
        worker.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                yield item
        finally:
            # Runs on normal completion AND when the consumer abandons the
            # generator (break / exception -> GeneratorExit): release the
            # producer, drain, and join so nothing leaks.
            stop.set()
            while True:
                try:
                    out.get_nowait()
                except queue.Empty:
                    break
            worker.join()
        if error:
            raise error[0]
