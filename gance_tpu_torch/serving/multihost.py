"""
Multi-process online serving: the synthesis daemon over a mesh that spans
processes (the counterpart of gance_tpu/serving/multihost.py, with its
protocol, its messages, its timeouts and their environment variables).

The offline render CLIs already run over several processes (--dist-*): every
process derives the same frame schedule from the input file, so all of them
reach every collective in the same order with no coordination beyond
torch.distributed itself. An online daemon breaks that symmetry: batches are
request-driven and exist only on the process that accepted the HTTP
connection. This module restores the order with a coordinator -> worker
control channel:

  * The coordinator (process 0) runs the HTTP server and the DynamicBatcher
    unchanged. Its networks are wrapped in `MultiHostNetwork` proxies: every
    device dispatch first BROADCASTS a batch descriptor (network index, lane
    kind, the bucketed rows: latents, never images) over plain TCP to every
    worker, then runs the same sharded call and the collective host fetch
    itself.
  * Workers (process 1..N-1) never bind HTTP. They loop on the control
    socket and mirror each descriptor: the same network, the same call, the
    same `fetch_to_host` all_gather, reaching every collective in the same
    order as the coordinator. The batch's rows split over 'data' across the
    processes; params stay tensor-parallel over 'model' inside each process.

Correctness hinges on ORDER: all processes must run the same collectives in
the same sequence. Two properties guarantee it here: the batcher serializes
all device work through one dispatch thread, and the proxy performs
broadcast -> compute -> fetch as one unit inside that thread. The fetch of a
batch sharded over a process-spanning mesh is an all_gather of its frames
through the host (`parallel/mesh.py::ShardedRows.fetch`); it runs in the
dispatch thread, so no collective ever runs outside it. JAX launches a
replicate program there instead and keeps the device/egress overlap; the
port's host gather waits for the batch in the dispatch thread.

Failure semantics (the part the offline CLIs get for free from their
deterministic schedules):
  * Every dispatch is ACKed on RECEIPT by every worker (one control-channel
    round trip, microseconds against a device batch). A dead or wedged
    worker surfaces as an ACK timeout on the NEXT dispatch: the channel
    marks itself broken, fails the in-flight request, and every subsequent
    request fails fast: with one participant gone, no collective can ever
    complete, so the daemon must stop serving rather than hang.
  * The coordinator heartbeats (fire-and-forget, no ACK) every few seconds
    so idle workers can bound their recv timeout; a worker whose socket
    goes silent past the timeout exits loudly (coordinator presumed dead)
    instead of blocking in recv forever.
  * Clean shutdown is an explicit broadcast: workers ACK it and exit 0.
  * A worker wedged INSIDE a collective (device hang) is bounded by the
    daemon's per-request timeout (the HTTP side returns 503), the same
    contract as single-process serving.

The connection handshake carries a network FINGERPRINT (per network: vector
length, resolution, style rows) so that a worker launched with different
pickles fails at connect time, not as a shape error mid-collective.
"""

import hmac
import hashlib
import io
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from gance_tpu_torch.parallel.mesh import ShardedRows, fetch_to_host
from gance_tpu_torch.utils.logging import LOGGER

PROTOCOL_VERSION = 1
# Length-prefixed pickle frames. Descriptors are latents (48 x 18 x 512 fp32
# ~= 1.8 MB worst case); anything near the cap is a protocol bug, not a batch.
_FRAME_HEADER = struct.Struct("!Q")
MAX_FRAME_BYTES = 256 * 1024 * 1024

# ---- control-channel authentication ----
# Frames are pickles, and unpickling attacker bytes is remote code execution —
# so no frame is ever parsed from an unauthenticated peer. Every connection
# starts with a MUTUAL challenge-response handshake keyed on the shared secret
# in GANCE_TPU_SERVE_TOKEN (set the same value on every host): the coordinator
# sends a magic + nonce, the worker proves knowledge of the token over that
# nonce and issues its own nonce, the coordinator proves back. Raw fixed-size
# bytes only — a scanner or stray client is dropped before pickle ever runs.
# On top of that, frames decode through a restricted unpickler that admits
# only the types descriptors actually carry (dict/str/int/ndarray).
_AUTH_MAGIC = b"GTPU1"
_AUTH_NONCE_BYTES = 32
_AUTH_DIGEST_BYTES = 32  # sha256
_AUTH_HANDSHAKE_TIMEOUT_S = 10.0


def _control_token() -> bytes:
    token = os.environ.get("GANCE_TPU_SERVE_TOKEN", "")
    return token.encode()


def _auth_digest(token: bytes, role: bytes, nonce: bytes) -> bytes:
    return hmac.new(token, b"gance-serve-auth:" + role + nonce, hashlib.sha256).digest()


def authenticate_as_coordinator(sock: socket.socket) -> bool:
    """Coordinator half of the mutual handshake. Returns False (peer is not
    one of ours) instead of raising on garbage — accept() keeps listening."""
    token = _control_token()
    nonce = os.urandom(_AUTH_NONCE_BYTES)
    try:
        sock.sendall(_AUTH_MAGIC + nonce)
        reply = _recv_exact(sock, _AUTH_DIGEST_BYTES + _AUTH_NONCE_BYTES)
    except (OSError, MultiHostServingError):
        return False
    digest, worker_nonce = (
        reply[:_AUTH_DIGEST_BYTES], reply[_AUTH_DIGEST_BYTES:]
    )
    if not hmac.compare_digest(digest, _auth_digest(token, b"worker", nonce)):
        return False
    try:
        sock.sendall(_auth_digest(token, b"coordinator", worker_nonce))
    except OSError:
        return False
    return True


def authenticate_as_worker(sock: socket.socket) -> None:
    """Worker half: answer the coordinator's challenge, then verify the
    coordinator knows the token too (a rogue listener feeding pickle frames
    to a worker would be code execution on the worker)."""
    token = _control_token()
    greeting = _recv_exact(sock, len(_AUTH_MAGIC) + _AUTH_NONCE_BYTES)
    if greeting[: len(_AUTH_MAGIC)] != _AUTH_MAGIC:
        raise MultiHostServingError(
            "peer did not speak the serving control protocol"
        )
    nonce = greeting[len(_AUTH_MAGIC):]
    worker_nonce = os.urandom(_AUTH_NONCE_BYTES)
    sock.sendall(_auth_digest(token, b"worker", nonce) + worker_nonce)
    proof = _recv_exact(sock, _AUTH_DIGEST_BYTES)
    if not hmac.compare_digest(
        proof, _auth_digest(token, b"coordinator", worker_nonce)
    ):
        raise MultiHostServingError(
            "coordinator failed authentication (GANCE_TPU_SERVE_TOKEN "
            "mismatch between hosts?)"
        )


class _RestrictedUnpickler(pickle.Unpickler):
    """Defense in depth behind the HMAC handshake: control frames carry only
    dict/str/int/bytes/ndarray, so only numpy's array-reconstruction globals
    resolve; anything else (os.system, subprocess, __reduce__ payloads) is
    refused at name-resolution time."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.dtypes", "Float32DType"),
        ("numpy.dtypes", "Float64DType"),
        ("numpy.dtypes", "Int64DType"),
    }

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise MultiHostServingError(
            f"control frame referenced forbidden global {module}.{name}"
        )

MSG_HELLO = "hello"
MSG_ACK = "ack"
MSG_DISPATCH = "dispatch"
MSG_HEARTBEAT = "heartbeat"
MSG_SHUTDOWN = "shutdown"
# Hot model rollout is TWO-phase, as in JAX, where placing params onto a
# process-spanning mesh is a collective that every process must enter
# together (the port places each process's params without one, and keeps the
# protocol so that the fleets' slot tables change in lockstep). PREPARE
# parses the pickle host-side (fallible, completion-acked, recoverable: a bad
# path on one host aborts the rollout without breaking the channel), then
# COMMIT is receipt-acked and each worker places the network right after
# acking, with the coordinator placing its own the moment the acks land.
MSG_LOAD_PREPARE = "load_prepare"
MSG_LOAD_COMMIT = "load_commit"
MSG_LOAD_ABORT = "load_abort"  # drop staged params after a peer's prepare failed
MSG_UNLOAD = "unload"  # drop a retired slot's params on every worker

# Prepare acks arrive on COMPLETION of the host-side parse; reading a
# config-f pickle takes seconds to minutes depending on storage, hence the
# separate generous bound.
DEFAULT_LOAD_TIMEOUT_S = float(
    os.environ.get("GANCE_TPU_SERVE_LOAD_TIMEOUT_S", "900")
)

DEFAULT_ACK_TIMEOUT_S = float(os.environ.get("GANCE_TPU_SERVE_ACK_TIMEOUT_S", "60"))
DEFAULT_HEARTBEAT_INTERVAL_S = float(
    os.environ.get("GANCE_TPU_SERVE_HEARTBEAT_S", "10")
)
# Workers tolerate this much control-channel silence while IDLE (heartbeats
# arrive every DEFAULT_HEARTBEAT_INTERVAL_S, so silence means a dead
# coordinator). Time spent inside a mirrored collective does not count — the
# timeout clock only runs while blocked in recv.
DEFAULT_WORKER_TIMEOUT_S = float(
    os.environ.get("GANCE_TPU_SERVE_WORKER_TIMEOUT_S", "90")
)


class MultiHostServingError(RuntimeError):
    """The control channel failed: a peer died, timed out, or spoke garbage."""


def _send_frame(sock: socket.socket, payload: Any) -> None:
    data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    if len(data) > MAX_FRAME_BYTES:
        raise MultiHostServingError(
            f"control frame of {len(data)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap (descriptors carry latents, never images)"
        )
    sock.sendall(_FRAME_HEADER.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, count: int) -> bytes:
    buffer = bytearray(count)
    view = memoryview(buffer)
    got = 0
    while got < count:
        read = sock.recv_into(view[got:], count - got)
        if read == 0:
            raise MultiHostServingError("control channel closed by peer")
        got += read
    return bytes(buffer)


def _recv_frame(sock: socket.socket) -> Any:
    (length,) = _FRAME_HEADER.unpack(_recv_exact(sock, _FRAME_HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise MultiHostServingError(f"oversized control frame ({length} bytes)")
    return _RestrictedUnpickler(io.BytesIO(_recv_exact(sock, length))).load()


def _replicate_or_fetch(network: Any, images: Any) -> Any:
    """
    Post-dispatch hand-off that keeps collectives in the CALLING thread:
    frames sharded over a process-spanning mesh are gathered to the host now
    (an all_gather every process reaches in this order), so that any later
    thread reads them without a collective. Anything else (a one-process
    mesh's shards, a device tensor, a fake's numpy) is returned as it is;
    the batcher's fetch thread copies it.
    """
    if isinstance(images, ShardedRows) and images.mesh.grouped:
        return images.fetch()
    return images


def _device_fn(network: Any, kind: str) -> Callable:
    """Device entry point for a lane kind, with the batcher's fallback rule:
    networks exposing only the generic (rank-dispatching) surface work too."""
    name = (
        "device_images_from_matrices" if kind == "w+" else "device_images_from_vectors"
    )
    fn = getattr(network, name, None)
    return fn if fn is not None else network.device_images_generic


def network_fingerprint(networks: Sequence[Any]) -> List[Tuple]:
    """What every process must agree on before the first collective: the
    served network list's shapes (a mismatch would otherwise surface as a
    cryptic cross-host shape error mid-dispatch)."""
    fingerprint = []
    for network in networks:
        config = getattr(network, "config", None)
        fingerprint.append(
            (
                int(network.expected_vector_length),
                int(getattr(network, "resolution", 0)),
                int(config.num_style_rows) if config is not None else None,
            )
        )
    return fingerprint


class ControlCoordinator:
    """
    Coordinator (process 0) side of the control channel: accept one TCP
    connection per worker, broadcast dispatch descriptors with receipt-ACKs,
    heartbeat while idle, and mark the whole channel broken on the first
    peer failure (collectives cannot survive a lost participant).
    """

    def __init__(
        self,
        num_workers: int,
        bind_host: str = "0.0.0.0",
        port: int = 0,
        ack_timeout_s: float = DEFAULT_ACK_TIMEOUT_S,
        heartbeat_interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
    ) -> None:
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1 (use no channel for 1 process)")
        self.num_workers = int(num_workers)
        self.ack_timeout_s = float(ack_timeout_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind_host, port))
        self._listener.listen(self.num_workers)
        self.port = self._listener.getsockname()[1]
        self._workers: List[Tuple[int, socket.socket]] = []
        self._lock = threading.Lock()
        # Socket WRITES are serialized separately from the broadcast-operation
        # lock so the heartbeat thread can keep beating while a long
        # completion-acked broadcast (hot-load prepare: up to minutes of
        # pickle parsing) holds `_lock` — otherwise workers that finished
        # their prepare early would see idle-timeout silence and kill the
        # whole deployment (frames stay atomic; worker loops skip heartbeats
        # wherever they land in the stream).
        self._send_lock = threading.Lock()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self.failed = threading.Event()
        self._failure: Optional[str] = None
        self._closed = False
        self._stop_heartbeat = threading.Event()
        self._heartbeat_thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def accept(
        self, fingerprint: List[Tuple], timeout_s: float = 600.0
    ) -> "ControlCoordinator":
        """Wait for every worker's hello; verify auth + protocol + network
        list. Stray connections (scanners, LB health probes, bad tokens,
        malformed hellos) are dropped and the listener keeps waiting for the
        remaining real workers — only a fingerprint mismatch from an
        AUTHENTICATED worker is fatal (a misconfigured fleet, not noise)."""
        if not _control_token():
            LOGGER.warning(
                "GANCE_TPU_SERVE_TOKEN is unset: the serving control channel "
                "authenticates with an empty shared secret. Set the same "
                "token on every host for any non-loopback deployment."
            )
        self._listener.settimeout(timeout_s)
        deadline = time.monotonic() + timeout_s
        try:
            while len(self._workers) < self.num_workers:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise MultiHostServingError(
                        f"only {len(self._workers)}/{self.num_workers} workers "
                        f"connected within {timeout_s:g}s"
                    )
                self._listener.settimeout(remaining)
                try:
                    sock, address = self._listener.accept()
                except socket.timeout as error:
                    raise MultiHostServingError(
                        f"only {len(self._workers)}/{self.num_workers} workers "
                        f"connected within {timeout_s:g}s"
                    ) from error
                # The handshake gets a short bound of its own so one stalled
                # connection cannot eat the whole accept window.
                sock.settimeout(min(_AUTH_HANDSHAKE_TIMEOUT_S, remaining))
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if not authenticate_as_coordinator(sock):
                    LOGGER.warning(
                        "serving control channel: dropped unauthenticated "
                        "connection from %s", address,
                    )
                    sock.close()
                    continue
                try:
                    hello = _recv_frame(sock)
                except (OSError, MultiHostServingError) as error:
                    LOGGER.warning(
                        "serving control channel: dropped connection from %s "
                        "(no valid hello: %s)", address, error,
                    )
                    sock.close()
                    continue
                if (
                    not isinstance(hello, dict)
                    or hello.get("type") != MSG_HELLO
                    or hello.get("protocol") != PROTOCOL_VERSION
                ):
                    LOGGER.warning(
                        "serving control channel: dropped connection from %s "
                        "(bad hello: %r)", address, hello,
                    )
                    sock.close()
                    continue
                sock.settimeout(self.ack_timeout_s)
                if hello.get("fingerprint") != fingerprint:
                    problem = (
                        f"worker {hello.get('process_id')} serves different "
                        f"networks: {hello.get('fingerprint')} != {fingerprint}"
                    )
                    try:
                        _send_frame(sock, {"type": MSG_SHUTDOWN, "error": problem})
                    finally:
                        sock.close()
                    raise MultiHostServingError(problem)
                self._workers.append((int(hello.get("process_id", -1)), sock))
                LOGGER.info(
                    "serving control channel: worker %s connected from %s "
                    "(%d/%d)",
                    hello.get("process_id"), address,
                    len(self._workers), self.num_workers,
                )
        except Exception:
            self._fail("worker handshake failed")
            self._listener.close()
            raise
        self._listener.close()  # every worker is in; no more connections
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, name="serving-control-heartbeat",
            daemon=True,
        )
        self._heartbeat_thread.start()
        return self

    def shutdown(self) -> None:
        """Broadcast a clean shutdown (workers ACK best-effort and exit 0)."""
        self._stop_heartbeat.set()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not self.failed.is_set():
                message = {"type": MSG_SHUTDOWN, "seq": self._next_seq()}
                for _pid, sock in self._workers:
                    try:
                        self._send_serialized(sock, message)
                    except OSError:
                        pass  # a dying worker must not block shutdown
                for _pid, sock in self._workers:
                    try:
                        sock.settimeout(5.0)
                        _recv_frame(sock)
                    except (OSError, MultiHostServingError):
                        pass
            self._close_sockets_locked()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=5)

    def close(self) -> None:
        """shutdown() without the courtesy broadcast (failure paths)."""
        self._stop_heartbeat.set()
        with self._lock:
            self._closed = True
            self._close_sockets_locked()

    def __enter__(self) -> "ControlCoordinator":
        return self

    def __exit__(self, *_exc: Any) -> None:
        self.shutdown()

    # ---- dispatch ----

    def broadcast_dispatch(self, network_index: int, kind: str, rows: np.ndarray) -> None:
        """Send one batch descriptor to every worker and wait for receipt-ACKs.

        Raises MultiHostServingError (and latches `failed`) on the first peer
        problem — after that every call fails fast, because a collective with
        a missing participant would hang all surviving processes.
        """
        with self._lock:
            self._broadcast_acked_locked(
                {
                    "type": MSG_DISPATCH,
                    "network": int(network_index),
                    "kind": kind,
                    "rows": np.ascontiguousarray(rows),
                }
            )

    def broadcast_load(self, path: str, index: int) -> None:
        """Run the worker half of a two-phase hot rollout (see the MSG_LOAD_*
        commentary at the top of this file for why one message deadlocks).

        PREPARE: every worker parses the pickle host-side and acks on
        completion. A worker that cannot (missing file, corrupt pickle) acks
        the error instead — the coordinator then broadcasts an ABORT so
        peers drop their staged params, and raises WITHOUT breaking the
        channel: the daemon keeps serving its existing networks.

        COMMIT: receipt-acked. Each worker acks and immediately places the
        network on its mesh; when this method returns, the CALLER must
        construct the coordinator's own copy before issuing any further
        device work (the daemon guarantees that by running loads under the
        batcher's device-op lock). If that coordinator-side construction
        FAILS, the caller must fail() the channel: workers committed a slot
        the coordinator doesn't hold, which is unrecoverable.

        While PREPARE waits (up to minutes of pickle parsing), dispatches
        queue behind this broadcast's lock — multi-host serving pauses during
        a rollout's parse phase because each worker's recv loop is busy
        parsing and could not ack dispatches anyway. Heartbeats keep flowing
        (separate send path), so workers that finish early stay alive.
        """
        with self._lock:
            errors = self._broadcast_acked_locked(
                {
                    "type": MSG_LOAD_PREPARE,
                    "path": str(path),
                    "index": int(index),
                },
                ack_timeout_s=DEFAULT_LOAD_TIMEOUT_S,
                collect_errors=True,
            )
            if errors:
                self._broadcast_acked_locked(
                    {"type": MSG_LOAD_ABORT, "index": int(index)}
                )
                raise MultiHostServingError(
                    "hot load failed on worker(s): "
                    + "; ".join(f"{pid}: {error}" for pid, error in errors)
                )
            self._broadcast_acked_locked(
                {"type": MSG_LOAD_COMMIT, "index": int(index)}
            )

    def broadcast_unload(self, index: int) -> None:
        """Tell every worker to drop slot `index`'s params (the coordinator
        already drained the lane — no dispatch for it can follow)."""
        with self._lock:
            self._broadcast_acked_locked(
                {"type": MSG_UNLOAD, "index": int(index)}
            )

    # ---- internals ----

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def _send_serialized(self, sock: socket.socket, payload: Any) -> None:
        """All socket writes go through here: the heartbeat thread and the
        broadcast path write concurrently, and interleaved frame bytes would
        corrupt the stream."""
        with self._send_lock:
            _send_frame(sock, payload)

    def _fail(self, reason: str) -> None:
        if self._failure is None:
            self._failure = reason
        self.failed.set()
        self._stop_heartbeat.set()

    def fail(self, reason: str) -> None:
        """Latch the channel broken from OUTSIDE (e.g. the coordinator's own
        half of a hot-load commit failed after the workers were told to
        commit: the fleets' slot tables would silently diverge, and no recovery
        protocol exists, so serving must stop loudly)."""
        with self._lock:
            self._fail(reason)
            self._close_sockets_locked()

    def _check_usable_locked(self) -> None:
        if self.failed.is_set():
            raise MultiHostServingError(
                f"control channel is broken ({self._failure}); the daemon "
                "cannot continue collectives with a lost participant"
            )
        if self._closed:
            raise MultiHostServingError("control channel is closed")

    def _close_sockets_locked(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        for _pid, sock in self._workers:
            try:
                sock.close()
            except OSError:
                pass

    def _broadcast_acked_locked(
        self,
        message: dict,
        ack_timeout_s: Optional[float] = None,
        collect_errors: bool = False,
    ) -> List[Tuple[int, str]]:
        """Send `message` to every worker and wait for one ack each. Socket
        failures, timeouts, and malformed acks are always fatal (channel
        latched broken). Error-carrying acks are fatal too UNLESS
        `collect_errors` — then they are returned, because a prepare-phase
        failure is recoverable (nothing has diverged yet)."""
        self._check_usable_locked()
        timeout = self.ack_timeout_s if ack_timeout_s is None else ack_timeout_s
        message["seq"] = self._next_seq()
        errors: List[Tuple[int, str]] = []
        for pid, sock in self._workers:
            try:
                self._send_serialized(sock, message)
            except OSError as error:
                self._fail(f"send to worker {pid} failed: {error}")
                self._close_sockets_locked()
                raise MultiHostServingError(
                    f"worker {pid} is unreachable: {error}"
                ) from error
        for pid, sock in self._workers:
            try:
                sock.settimeout(timeout)
                ack = _recv_frame(sock)
            except (OSError, MultiHostServingError, socket.timeout) as error:
                self._fail(f"worker {pid} did not ACK: {error}")
                self._close_sockets_locked()
                raise MultiHostServingError(
                    f"worker {pid} did not ACK {message['type']} "
                    f"{message['seq']} within {timeout:g}s: {error}"
                ) from error
            if (
                not isinstance(ack, dict)
                or ack.get("type") != MSG_ACK
                or ack.get("seq") != message["seq"]
            ):
                self._fail(f"worker {pid} sent a bad ACK: {ack!r}")
                self._close_sockets_locked()
                raise MultiHostServingError(
                    f"worker {pid} answered {message['type']} "
                    f"{message['seq']} with {ack!r}"
                )
            if ack.get("error"):
                if collect_errors:
                    errors.append((pid, str(ack["error"])))
                    continue
                # outside collect_errors an error ack means divergent
                # state with no recovery protocol — stop serving.
                self._fail(f"worker {pid}: {ack['error']}")
                self._close_sockets_locked()
                raise MultiHostServingError(
                    f"worker {pid} failed {message['type']}: {ack['error']}"
                )
        return errors

    def _heartbeat_loop(self) -> None:
        # Fire-and-forget (no ACK): its only job is to keep idle workers'
        # recv timeouts from firing, so workers can treat control-channel
        # silence as a dead coordinator. Deliberately does NOT take the
        # broadcast lock: a hot-load PREPARE broadcast can hold it for
        # minutes (pickle parsing on the slowest host) and the workers that
        # acked early are back in recv counting silence — the beat must keep
        # flowing exactly then. Writes are frame-atomic via _send_serialized;
        # workers skip BEAT frames wherever they land in the stream.
        while not self._stop_heartbeat.wait(self.heartbeat_interval_s):
            if self._closed or self.failed.is_set():
                return
            message = {"type": MSG_HEARTBEAT, "seq": self._next_seq()}
            for pid, sock in list(self._workers):
                try:
                    self._send_serialized(sock, message)
                except OSError as error:
                    # Latch only — closing sockets here could race a
                    # broadcast mid-ack-wait; the broadcast path (or the
                    # CLI's failed-event watch) performs the close.
                    self._fail(f"heartbeat to worker {pid} failed: {error}")
                    return


class MultiHostNetwork:
    """
    Coordinator-side proxy with the SynthesisNetwork serving surface: every
    device dispatch is broadcast to the workers first, then mirrored
    locally, then its frames are fetched (the collective host gather, in
    this thread), so the global collective order is exactly the
    control-message order. The batcher's fetch thread then only reads host
    arrays. Networks without a process-spanning mesh (fakes, one process)
    return their frames as they are.
    """

    def __init__(self, network: Any, coordinator: ControlCoordinator, index: int) -> None:
        self._network = network
        self._coordinator = coordinator
        self._index = int(index)

    # metadata the daemon/batcher reads
    @property
    def expected_vector_length(self) -> int:
        return self._network.expected_vector_length

    @property
    def resolution(self) -> int:
        return int(getattr(self._network, "resolution", 0))

    @property
    def config(self) -> Any:
        return getattr(self._network, "config", None)

    @property
    def path(self) -> Any:
        return getattr(self._network, "path", None)

    def _dispatch(self, kind: str, rows: np.ndarray, fn: Callable) -> Any:
        rows = np.asarray(rows, np.float32)
        self._coordinator.broadcast_dispatch(self._index, kind, rows)
        return _replicate_or_fetch(self._network, fn(rows))

    def device_images_from_vectors(self, z_batch: np.ndarray) -> np.ndarray:
        return self._dispatch("z", z_batch, _device_fn(self._network, "z"))

    def device_images_from_matrices(self, dlatent_batch: np.ndarray) -> np.ndarray:
        return self._dispatch("w+", dlatent_batch, _device_fn(self._network, "w+"))

    def device_images_generic(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch)
        if batch.ndim == 2:
            return self.device_images_from_vectors(batch)
        if batch.ndim == 3:
            return self.device_images_from_matrices(batch)
        raise ValueError(f"Cannot dispatch batch of shape {batch.shape}")

    def images_from_vectors(self, z_batch: np.ndarray) -> np.ndarray:
        return fetch_to_host(self.device_images_from_vectors(z_batch))

    def images_from_matrices(self, dlatent_batch: np.ndarray) -> np.ndarray:
        return fetch_to_host(self.device_images_from_matrices(dlatent_batch))

    def images_generic(self, batch: np.ndarray) -> np.ndarray:
        return fetch_to_host(self.device_images_generic(batch))


def wrap_networks_for_multihost(
    networks: Sequence[Any], coordinator: ControlCoordinator
) -> List[MultiHostNetwork]:
    return [
        MultiHostNetwork(network, coordinator, index)
        for index, network in enumerate(networks)
    ]


class ControlWorker:
    """Worker (process 1..N-1) side: connect, hello, then mirror messages."""

    def __init__(
        self,
        address: Tuple[str, int],
        process_id: int,
        fingerprint: List[Tuple],
        connect_timeout_s: float = 600.0,
    ) -> None:
        self.process_id = int(process_id)
        deadline = time.monotonic() + connect_timeout_s
        while True:
            try:
                self._sock = socket.create_connection(address, timeout=10.0)
                self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # Mutual auth precedes ANY pickle frame in either direction
                # (see the authenticate_* commentary up top). The TCP connect
                # can succeed (listener backlog) before the coordinator calls
                # accept(), so a handshake TIMEOUT retries like a refused
                # connect; an auth FAILURE (bad magic, token mismatch) raises.
                self._sock.settimeout(_AUTH_HANDSHAKE_TIMEOUT_S)
                authenticate_as_worker(self._sock)
                break
            except OSError as error:  # includes handshake timeouts
                try:
                    self._sock.close()
                except (OSError, AttributeError):
                    pass
                if time.monotonic() >= deadline:
                    raise MultiHostServingError(
                        f"could not reach the serving coordinator at "
                        f"{address}: {error}"
                    ) from error
                time.sleep(0.5)
        _send_frame(
            self._sock,
            {
                "type": MSG_HELLO,
                "protocol": PROTOCOL_VERSION,
                "process_id": self.process_id,
                "fingerprint": fingerprint,
            },
        )

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def run(
        self,
        networks: Sequence[Any],
        recv_timeout_s: float = DEFAULT_WORKER_TIMEOUT_S,
        load_prepare: Optional[Callable[[str, int], Any]] = None,
        load_commit: Optional[Callable[[Any, str, int], Any]] = None,
    ) -> int:
        """
        Mirror coordinator dispatches until a clean shutdown. Returns the
        number of dispatches served. Raises MultiHostServingError if the
        coordinator goes silent past `recv_timeout_s` (while idle — time
        inside a mirrored collective doesn't count) or closes the socket
        without saying shutdown.

        `load_prepare(path, index) -> staged` and
        `load_commit(staged, path, index) -> network` (both or neither)
        enable hot model rollout, mirroring the coordinator's two-phase
        /admin/load (see the MSG_LOAD_* commentary up top): prepare is the
        host-side pickle parse, acked on completion and allowed to fail
        (the rollout aborts, serving continues); commit is acked on receipt
        and then places the network on the mesh. A commit-phase failure is
        fatal (the slot tables diverge; the next collective would hang),
        exactly like a device error during a mirrored dispatch.
        """
        if (load_prepare is None) != (load_commit is None):
            raise ValueError("load_prepare and load_commit come as a pair")
        resident = list(networks)
        staged: Optional[Tuple[Any, str, int]] = None  # (staged, path, index)
        served = 0
        try:
            while True:
                self._sock.settimeout(recv_timeout_s)
                try:
                    message = _recv_frame(self._sock)
                except socket.timeout as error:
                    raise MultiHostServingError(
                        f"no control traffic for {recv_timeout_s:g}s "
                        "(heartbeats should arrive every "
                        f"{DEFAULT_HEARTBEAT_INTERVAL_S:g}s) — coordinator "
                        "presumed dead"
                    ) from error
                kind = message.get("type") if isinstance(message, dict) else None
                if kind == MSG_HEARTBEAT:
                    continue
                if kind == MSG_SHUTDOWN:
                    if "error" in message:
                        raise MultiHostServingError(
                            f"coordinator refused this worker: {message['error']}"
                        )
                    try:
                        _send_frame(
                            self._sock, {"type": MSG_ACK, "seq": message.get("seq")}
                        )
                    except OSError:
                        pass
                    LOGGER.info(
                        "serving worker %d: clean shutdown after %d dispatches",
                        self.process_id, served,
                    )
                    return served
                if kind == MSG_LOAD_PREPARE:
                    # Host-side parse only — no device work, so failure is
                    # recoverable: ack the error and keep serving (the
                    # coordinator aborts the rollout everywhere).
                    error: Optional[str] = None
                    try:
                        if load_prepare is None:
                            raise MultiHostServingError(
                                "this worker has no network loader"
                            )
                        if int(message["index"]) != len(resident):
                            raise MultiHostServingError(
                                f"slot skew: coordinator slot "
                                f"{message['index']}, worker has "
                                f"{len(resident)} networks"
                            )
                        staged = (
                            load_prepare(message["path"], int(message["index"])),
                            str(message["path"]),
                            int(message["index"]),
                        )
                    except Exception as prepare_error:  # noqa: BLE001
                        staged = None
                        error = str(prepare_error)
                        LOGGER.warning(
                            "serving worker %d: hot-load prepare of %s "
                            "failed: %s",
                            self.process_id, message.get("path"), error,
                        )
                    ack = {"type": MSG_ACK, "seq": message.get("seq")}
                    if error is not None:
                        ack["error"] = error
                    _send_frame(self._sock, ack)
                    continue
                if kind == MSG_LOAD_ABORT:
                    staged = None
                    _send_frame(
                        self._sock, {"type": MSG_ACK, "seq": message.get("seq")}
                    )
                    continue
                if kind == MSG_LOAD_COMMIT:
                    if staged is None or staged[2] != int(message["index"]):
                        # protocol corruption — error-ack BEFORE anyone
                        # enters the collective; the coordinator latches
                        # the channel broken.
                        _send_frame(
                            self._sock,
                            {
                                "type": MSG_ACK,
                                "seq": message.get("seq"),
                                "error": (
                                    f"commit for slot {message.get('index')} "
                                    f"but staged is "
                                    f"{None if staged is None else staged[2]}"
                                ),
                            },
                        )
                        raise MultiHostServingError(
                            "hot-load commit without a matching prepare"
                        )
                    # ACK on RECEIPT, then place the network: the
                    # coordinator places its own as soon as the acks land.
                    _send_frame(
                        self._sock, {"type": MSG_ACK, "seq": message.get("seq")}
                    )
                    staged_value, staged_path, staged_index = staged
                    staged = None
                    resident.append(
                        load_commit(staged_value, staged_path, staged_index)
                    )
                    LOGGER.info(
                        "serving worker %d: hot-loaded %s into slot %d",
                        self.process_id, staged_path, staged_index,
                    )
                    continue
                if kind == MSG_UNLOAD:
                    index = int(message["index"])
                    if not 0 < index < len(resident):
                        # Slot tables diverged (the daemon never unloads slot
                        # 0 and never references a slot it didn't load):
                        # error-ack so the coordinator latches the channel
                        # broken instead of silently keeping params this
                        # host was told to free.
                        _send_frame(
                            self._sock,
                            {
                                "type": MSG_ACK,
                                "seq": message.get("seq"),
                                "error": (
                                    f"unload slot {index} out of range "
                                    f"(worker has {len(resident)} slots)"
                                ),
                            },
                        )
                        raise MultiHostServingError(
                            f"unload for unknown slot {index}"
                        )
                    resident[index] = None  # params free with the ref
                    LOGGER.info(
                        "serving worker %d: dropped slot %d",
                        self.process_id, index,
                    )
                    _send_frame(
                        self._sock, {"type": MSG_ACK, "seq": message.get("seq")}
                    )
                    continue
                if kind != MSG_DISPATCH:
                    raise MultiHostServingError(f"unexpected control message {message!r}")
                # ACK on RECEIPT (before compute): the coordinator's ACK wait
                # must never include device time.
                _send_frame(self._sock, {"type": MSG_ACK, "seq": message.get("seq")})
                network = resident[int(message["network"])]
                # Run the same call and the same fetch collective as the
                # coordinator; the frames are discarded here (the
                # coordinator's copy feeds HTTP), but the all_gather needs
                # every participant. The fetch BLOCKS this worker until the
                # dispatch completes, which bounds how far device queues
                # can run ahead and surfaces device errors here, loudly.
                fetch_to_host(
                    _replicate_or_fetch(
                        network,
                        _device_fn(network, message["kind"])(message["rows"]),
                    )
                )
                served += 1
        finally:
            self.close()


def run_worker(
    networks: Sequence[Any],
    coordinator_host: str,
    control_port: int,
    process_id: int,
    recv_timeout_s: float = DEFAULT_WORKER_TIMEOUT_S,
    connect_timeout_s: float = 600.0,
    load_prepare: Optional[Callable[[str, int], Any]] = None,
    load_commit: Optional[Callable[[Any, str, int], Any]] = None,
) -> int:
    """Connect to the coordinator's control channel and serve until shutdown."""
    worker = ControlWorker(
        (coordinator_host, int(control_port)),
        process_id,
        network_fingerprint(networks),
        connect_timeout_s=connect_timeout_s,
    )
    return worker.run(
        networks,
        recv_timeout_s=recv_timeout_s,
        load_prepare=load_prepare,
        load_commit=load_commit,
    )
