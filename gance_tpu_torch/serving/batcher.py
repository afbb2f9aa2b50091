"""
Dynamic request batching for online synthesis serving (the counterpart of
gance_tpu/serving/batcher.py, with the same surface and semantics).

Concurrent requests are coalesced into device batches, padded to a small
fixed set of bucket sizes (`multiple`·2^k, capped at `max_batch`, the
runtime's `_bucket_size` rule), so that a server warms every batch shape it
will ever dispatch before it takes traffic. Device work and host egress
overlap through a bounded fetch queue: the dispatch thread queues a batch's
synthesis on the card's stream, then the copy of its frames into pinned host
memory and an event after that copy; the fetch thread waits on the event
before it reads the frames, while the dispatch thread is already queueing the
next batch. On a CUDA network the rows also go to the device from pinned
memory without blocking the dispatch thread, and the pinned buffer is kept
until the batch's event has fired.

A network on a mesh returns its frames as `parallel/mesh.py::ShardedRows`.
In one process the fetch thread copies them from their devices. Across
processes their fetch is an all_gather, a collective that every process
must reach in the same order, so it runs in the dispatch thread, under the
device lock, right after the batch is queued (the host gather waits for the
batch; JAX launches a replicate program there instead).
"""

import collections
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gance_tpu_torch.parallel.mesh import ShardedRows
from gance_tpu_torch.synthesis.runtime import _bucket_size, _start_host_copy
from gance_tpu_torch.utils.logging import LOGGER

# Lane kinds: z vectors (rank 2 input) and w+ matrices (rank 3). A request's
# lane is its network index, its kind and its full per-row shape: a device
# batch never mixes networks, kinds or row shapes.
LANE_VECTORS = "z"
LANE_MATRICES = "w+"


class _Request:
    """One submitted batch: rows are consumed (possibly across several device
    batches), parts accumulate in row order, the future resolves when all
    rows are done."""

    __slots__ = ("rows", "lane", "future", "parts", "remaining", "arrived")

    def __init__(self, rows: np.ndarray, lane: Tuple) -> None:
        self.rows = rows
        self.lane = lane
        self.future: "Future[np.ndarray]" = Future()
        self.parts: List[np.ndarray] = []
        self.remaining = rows.shape[0]
        self.arrived = time.monotonic()


def bucket_rows(real: int, max_batch: int, multiple: int = 8) -> int:
    """Smallest multiple·2^k >= real, capped at max_batch: the runtime's
    bucketing rule (`synthesis/runtime.py::_bucket_size`)."""
    return _bucket_size(real, max_batch, multiple=multiple)


def warmup_batch_sizes(max_batch: int, multiple: int = 8) -> List[int]:
    """Every bucket size `bucket_rows` can produce for this ceiling: the set a
    server warms so that no request meets a batch shape for the first time."""
    sizes: List[int] = []
    size = multiple
    while size < max_batch:
        sizes.append(size)
        size *= 2
    sizes.append(max_batch)
    return sizes


def _stage_rows(network: Any, rows: np.ndarray) -> Tuple[Any, Optional[torch.Tensor]]:
    """(what the network's entry point takes, the pinned buffer to keep alive).
    For a network on a CUDA device the rows are copied into pinned memory and
    queued to the device without blocking; anything else takes the numpy rows."""
    device = getattr(network, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        pinned = torch.from_numpy(rows).pin_memory()
        return pinned.to(device, non_blocking=True), pinned
    return rows, None


def _start_fetch(images: Any, real: int) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Queue the copy of the first `real` frames to pinned host memory and an
    event after it (CUDA tensors); frames sharded over a process-spanning
    mesh are gathered to the host here (the collective stays in the calling,
    dispatch thread); anything else passes through."""
    if isinstance(images, ShardedRows) and images.mesh.grouped:
        return images.fetch(), None
    if not (torch.is_tensor(images) and images.is_cuda):
        return images, None
    host = _start_host_copy(images, real)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _host_frames(images: Any, ready: Optional[torch.cuda.Event], real: int) -> np.ndarray:
    """The fetched frames as numpy, once the copy's event has fired."""
    if ready is not None:
        ready.synchronize()
    if isinstance(images, ShardedRows):  # one process: no collective
        images = images.fetch()
    if torch.is_tensor(images):
        images = images.cpu().numpy()
    return np.asarray(images)[:real]


class DynamicBatcher:
    """
    Coalesce concurrent synthesis requests into fixed-shape device batches.

    `network` is anything with the SynthesisNetwork serving surface
    (`device_images_from_vectors` / `device_images_from_matrices` or the
    generic `device_images_generic`, plus `expected_vector_length`), or a
    list of them.

    :param max_batch: device batch ceiling.
    :param max_delay_ms: linger: how long the dispatcher waits for more rows
        once it has at least one. 0 dispatches at once.
    :param queue_depth: bound on device batches in flight between dispatch
        and fetch (backpressure; 2 overlaps one batch's compute with the
        previous batch's egress).
    :param pad_multiple: bucket granularity (8: buckets 8, 16, 32 and 48 for
        the default ceiling).
    """

    def __init__(
        self,
        network: Any,
        max_batch: int = 48,
        max_delay_ms: float = 5.0,
        queue_depth: int = 2,
        pad_multiple: int = 8,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        # Several resident networks: a request addresses one with
        # submit(..., network_index=i), and the lane carries the index.
        self.networks: List[Any] = (
            list(network) if isinstance(network, (list, tuple)) else [network]
        )
        if not self.networks:
            raise ValueError("at least one network required")
        self.network = self.networks[0]
        self.max_batch = int(max_batch)
        self.max_delay = max(0.0, float(max_delay_ms)) / 1000.0
        self.pad_multiple = max(1, int(pad_multiple))
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._lock = threading.Condition()
        # Serializes the issue of device work: the dispatch thread holds it
        # around each batch, and run_exclusive() lets admin work (a hot load's
        # parameter copies) run between batches.
        self._device_lock = threading.Lock()
        self._closed = False
        # Every request whose future has not resolved (pending or in flight):
        # close() fails these so that no caller blocks forever.
        self._live: "set[_Request]" = set()
        self._fetch_queue: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        # per-network unresolved-request counts (under _lock), which
        # retire_network waits on
        self._net_live: List[int] = [0] * len(self.networks)
        self._stats_lock = threading.Lock()
        self._stat = {
            "requests": 0,
            "frames": 0,
            "batches": 0,
            "dispatched_rows": 0,  # includes bucket padding
            "errors": 0,
        }
        self._latencies: "collections.deque[float]" = collections.deque(maxlen=512)
        self._net_frames = [0] * len(self.networks)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="batcher-dispatch", daemon=True
        )
        self._fetch_thread = threading.Thread(
            target=self._fetch_loop, name="batcher-fetch", daemon=True
        )
        self._dispatch_thread.start()
        self._fetch_thread.start()

    # ---- public surface ----

    def submit(self, batch: np.ndarray, network_index: int = 0) -> "Future[np.ndarray]":
        """
        Enqueue a (B, V) z batch or (B, R, V) w+ batch for network
        `network_index`; the future resolves to the (B, H, W, 3) uint8 images
        in row order. Shape problems raise ValueError at once.
        """
        if not 0 <= network_index < len(self.networks):
            raise ValueError(
                f"network_index {network_index} out of range "
                f"(serving {len(self.networks)} networks)"
            )
        rows = np.asarray(batch, np.float32)
        if rows.ndim == 2:
            lane = (int(network_index), LANE_VECTORS) + rows.shape[1:]
        elif rows.ndim == 3:
            lane = (int(network_index), LANE_MATRICES) + rows.shape[1:]
        else:
            raise ValueError(
                f"batch must be (B, V) vectors or (B, R, V) matrices, got "
                f"shape {rows.shape}"
            )
        expected = getattr(self.networks[network_index], "expected_vector_length", None)
        if expected is not None and rows.shape[-1] != expected:
            raise ValueError(f"latent length {rows.shape[-1]} != network's {expected}")
        if rows.shape[0] == 0:
            raise ValueError("empty batch")
        request = _Request(rows, lane)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            # Checked under the lock that retire_network frees slots under.
            if self.networks[network_index] is None:
                raise ValueError(f"network {network_index} has been unloaded")
            self._pending.append(request)
            self._live.add(request)
            self._net_live[lane[0]] += 1
            self._lock.notify_all()
        with self._stats_lock:
            self._stat["requests"] += 1
        return request.future

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            out = dict(self._stat)
            latencies = sorted(self._latencies)
            if len(self.networks) > 1:
                out["frames_by_network"] = list(self._net_frames)
        out["max_batch"] = self.max_batch
        out["occupancy"] = (
            out["frames"] / out["dispatched_rows"] if out["dispatched_rows"] else None
        )
        if latencies:
            out["latency_p50_ms"] = round(latencies[len(latencies) // 2] * 1e3, 2)
            out["latency_p99_ms"] = round(
                latencies[min(len(latencies) - 1, int(len(latencies) * 0.99))] * 1e3, 2
            )
        return out

    def add_network(self, network: Any) -> int:
        """Hot-add a resident network and return its index. Indices stay
        stable (clients address networks by index or name): append-only,
        retired slots are not reused."""
        if network is None:
            raise ValueError("network must not be None")
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.networks.append(network)
            self._net_live.append(0)
            index = len(self.networks) - 1
        with self._stats_lock:
            self._net_frames.append(0)
        return index

    def retire_network(self, network_index: int, timeout_s: float = 600.0) -> bool:
        """
        Free a resident network's slot once its last request resolves. Callers
        stop routing new requests to the index first (the daemon marks it
        retired at the HTTP edge); this waits for the in-flight count to reach
        zero, then drops the reference, and the network's device memory goes
        with it. Returns False on timeout (slot left intact). Idempotent.
        """
        deadline = time.monotonic() + timeout_s
        with self._lock:
            if not 0 <= network_index < len(self.networks):
                raise ValueError(f"network_index {network_index} out of range")
            if network_index == 0:
                raise ValueError(
                    "network 0 is the daemon's identity (healthz surface); "
                    "retire is for hot-swapped additions"
                )
            while self._net_live[network_index] > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(timeout=remaining)
            self.networks[network_index] = None
        return True

    def run_exclusive(self, fn):
        """Run `fn` while no device batch is being issued (the dispatch thread
        holds the same lock around each batch)."""
        with self._device_lock:
            return fn()

    def live_requests(self) -> int:
        """Requests whose futures have not resolved yet (pending + in flight)."""
        with self._lock:
            return len(self._live)

    def wait_idle(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved (the drain half of
        a graceful shutdown; callers stop submitting first). False if the
        timeout expires with work still live."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while self.live_requests():
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        return True

    def close(self) -> None:
        """Shutdown without drain: pending and in-flight requests fail.

        A thread still inside a device call past the join timeout cannot
        strand a caller: the live set fails every unresolved future, and the
        late completion is a no-op (`_finish` tolerates resolved futures)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._lock.notify_all()
        self._dispatch_thread.join(timeout=30)
        try:
            # The sentinel goes in after dispatch has stopped; a full queue
            # (fetch thread stuck) is left to the timed join and the sweep.
            self._fetch_queue.put_nowait(None)
        except queue.Full:
            pass
        self._fetch_thread.join(timeout=30)
        with self._lock:
            self._pending.clear()
            live = list(self._live)
        for request in live:
            self._finish(request, error=RuntimeError("batcher closed"))

    def _finish(
        self,
        request: _Request,
        result: Optional[np.ndarray] = None,
        error: Optional[BaseException] = None,
    ) -> None:
        """Resolve a request's future once and drop it from the live set;
        tolerates the race with close()."""
        with self._lock:
            self._drop_live_locked(request)
        if request.future.done():
            return
        try:
            if error is not None:
                request.future.set_exception(error)
            else:
                request.future.set_result(result)
        except Exception:  # pylint: disable=broad-except
            pass  # lost the race to close(); the future already resolved

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    # ---- internals ----

    def _drop_live_locked(self, request: _Request) -> None:
        """Remove a request from the live set once (idempotent), keeping the
        per-network live counts accurate."""
        if request in self._live:
            self._live.remove(request)
            self._net_live[request.lane[0]] -= 1
            self._lock.notify_all()

    def _take_batch(self) -> Optional[List[Tuple[_Request, int, np.ndarray]]]:
        """Under the lock: wait for work, linger, then consume up to max_batch
        rows of one lane from the queue front. Returns [(request,
        rows_consumed, row_slice)], or None on close."""
        with self._lock:
            while not self._closed:
                # Requests whose future already resolved (a failed slice of a
                # split request, or a caller's cancel) burn no device batches.
                while self._pending and self._pending[0].future.done():
                    dead = self._pending.popleft()
                    self._drop_live_locked(dead)
                if self._pending:
                    break
                self._lock.wait()
            if self._closed:
                return None
            if self.max_delay:
                # Linger for company, but stop once a full batch is queued.
                deadline = time.monotonic() + self.max_delay
                while time.monotonic() < deadline and not self._closed:
                    lane = self._pending[0].lane
                    queued = sum(r.rows.shape[0] for r in self._pending if r.lane == lane)
                    if queued >= self.max_batch:
                        break
                    self._lock.wait(timeout=deadline - time.monotonic())
                if self._closed:
                    return None
            lane: Optional[Tuple] = None  # the first live request's
            consumed: List[Tuple[_Request, int, np.ndarray]] = []
            total = 0
            while self._pending and total < self.max_batch:
                head = self._pending[0]
                if head.future.done():  # failed or cancelled: skip its rows
                    self._pending.popleft()
                    self._drop_live_locked(head)
                    continue
                if lane is None:
                    lane = head.lane
                elif head.lane != lane:
                    break  # another lane; the next dispatch takes it
                take = min(head.rows.shape[0], self.max_batch - total)
                consumed.append((head, take, head.rows[:take]))
                total += take
                if take == head.rows.shape[0]:
                    self._pending.popleft()
                else:
                    # Partial consume: the tail stays queued for the next
                    # dispatch; the fetch thread counts `remaining` down.
                    head.rows = head.rows[take:]
                    break
            return consumed

    def _issue(self, lane: Tuple, rows: np.ndarray, real: int):
        """Queue one padded batch on its lane's network (network index + kind;
        networks with only the generic, rank-dispatching surface work too)
        and the copy of its first `real` frames to the host. Returns (frames
        on their way to the host, the copy's event, the pinned input). No
        reference to the network outlives the call, so a retired network's
        memory is freed at once."""
        with self._device_lock:
            network = self.networks[lane[0]]
            name = (
                "device_images_from_vectors"
                if lane[1] == LANE_VECTORS
                else "device_images_from_matrices"
            )
            fn = getattr(network, name, None) or network.device_images_generic
            staged, pinned = _stage_rows(network, rows)
            images, ready = _start_fetch(fn(staged), real)
        return images, ready, pinned

    def _dispatch_loop(self) -> None:
        while True:
            consumed = self._take_batch()
            if consumed is None:
                return
            if not consumed:  # only dead requests were queued
                continue
            lane = consumed[0][0].lane
            rows = np.concatenate([slice_ for _req, _take, slice_ in consumed])
            real = rows.shape[0]
            bucket = bucket_rows(real, self.max_batch, self.pad_multiple)
            if bucket > real:
                pad = np.zeros((bucket - real,) + rows.shape[1:], rows.dtype)
                rows = np.concatenate([rows, pad])
            try:
                images, ready, pinned = self._issue(lane, rows, real)
            except Exception as error:  # pylint: disable=broad-except
                LOGGER.exception("serving dispatch failed")
                with self._stats_lock:
                    self._stat["errors"] += 1
                for request, _take, _slice in consumed:
                    self._finish(request, error=error)
                continue
            with self._stats_lock:
                self._stat["batches"] += 1
                self._stat["frames"] += real
                self._stat["dispatched_rows"] += bucket
                self._net_frames[lane[0]] += real
            meta = [(request, take) for request, take, _slice in consumed]
            while True:
                try:
                    # Bounded put = backpressure; re-check closed so that a
                    # dead fetch thread cannot strand this one.
                    self._fetch_queue.put((images, ready, pinned, meta, real), timeout=1.0)
                    break
                except queue.Full:
                    if self._closed:
                        for request, _take in meta:
                            self._finish(request, error=RuntimeError("batcher closed"))
                        return

    def _fetch_loop(self) -> None:
        while True:
            item = self._fetch_queue.get()
            if item is None:
                return
            images, ready, _pinned, consumed, real = item
            try:
                # the pinned input buffer (_pinned) lives until here, after
                # the event that follows its copy has fired
                host = _host_frames(images, ready, real)
            except Exception as error:  # pylint: disable=broad-except
                LOGGER.exception("serving fetch failed")
                with self._stats_lock:
                    self._stat["errors"] += 1
                for request, _take in consumed:
                    self._finish(request, error=error)
                continue
            del item, images, _pinned
            offset = 0
            for request, take in consumed:
                if request.future.done():
                    # An earlier slice failed, or the caller cancelled while
                    # the batch was in flight: drop the rows and the live-set
                    # entry, or wait_idle and retire would never drain.
                    with self._lock:
                        self._drop_live_locked(request)
                    offset += take
                    continue
                request.parts.append(host[offset: offset + take])
                offset += take
                request.remaining -= take
                if request.remaining == 0:
                    result = (
                        request.parts[0]
                        if len(request.parts) == 1
                        else np.concatenate(request.parts)
                    )
                    with self._stats_lock:
                        self._latencies.append(time.monotonic() - request.arrived)
                    self._finish(request, result=result)


def default_max_batch() -> int:
    """GANCE_TPU_SERVE_BATCH, else 48 (the JAX package's default)."""
    return int(os.environ.get("GANCE_TPU_SERVE_BATCH", "48"))
