"""
Multi-process online serving in the port (gance_tpu_torch/serving/
multihost.py): the 18 tests of tests/test_serving_multihost.py against the
port's control channel, proxies, daemon and serve CLI.

  * In-process tests of the control channel and the proxy over real
    localhost sockets and fake networks: dispatch mirroring, fingerprint
    rejection, dead-worker detection (ACK timeout / EOF), the worker's recv
    timeout, heartbeat liveness, fail-fast after the first break, the
    challenge-response handshake and the restricted unpickler, the two-phase
    hot load, and the full HTTP daemon over the proxies (the audio routes and
    the projection blend included).
  * The serve CLI's partial --dist-* triple, JAX's usage error.
  * An executed two-process test: the real daemon over a mesh spanning two
    gloo processes, each with a data 1 x model 2 group of CPU slots (data 2 x
    model 2 in all, the model axis inside each process), real HTTP requests
    and a hot load, against one process serving the same requests over the
    same mesh shape: equal bit for bit (every data row computes the same rows
    with the same blocks).
"""

import pickle
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gance_tpu_torch.serving.multihost import (  # noqa: E402
    ControlCoordinator,
    ControlWorker,
    MultiHostServingError,
    authenticate_as_coordinator,
    authenticate_as_worker,
    network_fingerprint,
    run_worker,
    wrap_networks_for_multihost,
)
from gance_tpu_torch.synthesis.runtime import FakeSynthesisNetwork  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

VECTOR_LENGTH = 32


def _accept_async(coordinator, fingerprint, timeout_s=30.0):
    """coordinator.accept on a thread — the auth handshake is interactive
    (challenge/response), so accept must run concurrently with any
    hand-rolled worker connection."""
    result = {}

    def target():
        try:
            coordinator.accept(fingerprint, timeout_s=timeout_s)
        except BaseException as error:  # noqa: BLE001
            result["error"] = error

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    return thread, result


def _manual_worker_connect(port, fingerprint, process_id=1):
    """A hand-rolled worker: authenticated TCP + hello, no run loop — for
    tests that need a connected-but-misbehaving peer. The coordinator's
    accept() must already be running (see _accept_async)."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    sock.settimeout(10.0)
    authenticate_as_worker(sock)
    payload = pickle.dumps(
        {
            "type": "hello", "protocol": 1, "process_id": process_id,
            "fingerprint": fingerprint,
        }
    )
    sock.sendall(struct.pack("!Q", len(payload)) + payload)
    return sock


class _RecordingFake(FakeSynthesisNetwork):
    """Fake that records every device batch it renders (thread-safe)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.device_batches = []
        self._lock = threading.Lock()

    def device_images_from_vectors(self, z_batch):
        with self._lock:
            self.device_batches.append(("z", np.asarray(z_batch).shape))
        return self._render(np.asarray(z_batch))

    def device_images_from_matrices(self, dlatent_batch):
        with self._lock:
            self.device_batches.append(("w+", np.asarray(dlatent_batch).shape))
        return self._render(np.asarray(dlatent_batch)[:, 0, :])


def _fake(resolution: int = 16) -> FakeSynthesisNetwork:
    return FakeSynthesisNetwork(
        resolution=resolution, expected_vector_length=VECTOR_LENGTH
    )


def _worker_thread(networks, port, process_id=1, recv_timeout_s=30.0):
    """run_worker on a thread; returns (thread, result dict)."""
    result = {}

    def target():
        try:
            result["served"] = run_worker(
                networks, "127.0.0.1", port, process_id,
                recv_timeout_s=recv_timeout_s, connect_timeout_s=30.0,
            )
        except BaseException as error:  # noqa: BLE001 - surfaced by the test
            result["error"] = error

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    return thread, result


def test_dispatch_mirrors_on_worker_and_images_match():
    """Every proxy dispatch reaches the worker with the same lane + shape,
    the coordinator's images equal a direct render, and a clean shutdown
    returns the worker with the exact dispatch count."""
    coordinator_net = _fake()
    worker_net = _RecordingFake(
        resolution=16, expected_vector_length=VECTOR_LENGTH
    )
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, heartbeat_interval_s=0.2
    )
    thread, result = _worker_thread([worker_net], coordinator.port)
    coordinator.accept(network_fingerprint([coordinator_net]), timeout_s=30.0)
    (proxy,) = wrap_networks_for_multihost([coordinator_net], coordinator)

    assert proxy.expected_vector_length == VECTOR_LENGTH
    assert proxy.resolution == 16

    rng = np.random.RandomState(0)
    z = rng.randn(4, VECTOR_LENGTH).astype(np.float32)
    images_z = proxy.device_images_from_vectors(z)
    np.testing.assert_array_equal(images_z, coordinator_net.images_generic(z))

    w = rng.randn(2, 6, VECTOR_LENGTH).astype(np.float32)
    images_w = proxy.device_images_from_matrices(w)
    assert images_w.shape == (2, 16, 16, 3)

    coordinator.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert result.get("served") == 2, result
    assert worker_net.device_batches == [
        ("z", (4, VECTOR_LENGTH)),
        ("w+", (2, 6, VECTOR_LENGTH)),
    ]
    assert not coordinator.failed.is_set()


def test_fingerprint_mismatch_refused_at_connect():
    """A worker loaded with different pickles must fail at handshake, not as
    a cross-host shape error mid-collective."""
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0
    )
    thread, result = _worker_thread([_fake(resolution=8)], coordinator.port)
    with pytest.raises(MultiHostServingError, match="different networks"):
        coordinator.accept(network_fingerprint([_fake(resolution=32)]), timeout_s=30.0)
    thread.join(timeout=10)
    assert isinstance(result.get("error"), MultiHostServingError)
    assert "refused" in str(result["error"])
    coordinator.close()


def test_dead_worker_breaks_channel_and_fails_fast():
    """A worker that vanishes surfaces as a dispatch error (EOF on the ACK
    read), latches `failed`, and every later dispatch fails immediately."""
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, ack_timeout_s=5.0
    )
    fingerprint = network_fingerprint([_fake()])
    accept_thread, accept_result = _accept_async(coordinator, fingerprint)
    sock = _manual_worker_connect(coordinator.port, fingerprint)
    accept_thread.join(timeout=30)
    assert "error" not in accept_result, accept_result
    sock.close()  # the worker dies

    rows = np.zeros((2, VECTOR_LENGTH), np.float32)
    with pytest.raises(MultiHostServingError):
        coordinator.broadcast_dispatch(0, "z", rows)
    assert coordinator.failed.is_set()
    started = time.monotonic()
    with pytest.raises(MultiHostServingError, match="broken"):
        coordinator.broadcast_dispatch(0, "z", rows)
    assert time.monotonic() - started < 1.0  # fails fast, no fresh timeout
    coordinator.close()


def test_silent_worker_hits_ack_timeout():
    """A connected-but-wedged worker (never ACKs) bounds the dispatch wait."""
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, ack_timeout_s=0.5,
        heartbeat_interval_s=3600.0,
    )
    fingerprint = network_fingerprint([_fake()])
    accept_thread, accept_result = _accept_async(coordinator, fingerprint)
    sock = _manual_worker_connect(coordinator.port, fingerprint)
    accept_thread.join(timeout=30)
    assert "error" not in accept_result, accept_result
    try:
        with pytest.raises(MultiHostServingError, match="did not ACK"):
            coordinator.broadcast_dispatch(
                0, "z", np.zeros((1, VECTOR_LENGTH), np.float32)
            )
        assert coordinator.failed.is_set()
    finally:
        sock.close()
        coordinator.close()


def test_worker_times_out_on_silent_coordinator():
    """Control-channel silence past the recv timeout means a dead
    coordinator: the worker exits loudly instead of blocking forever."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    accepted = {}

    def silent_coordinator():
        conn, _addr = listener.accept()
        authenticate_as_coordinator(conn)  # complete the handshake...
        accepted["conn"] = conn  # ...then read nothing, send nothing

    thread = threading.Thread(target=silent_coordinator, daemon=True)
    thread.start()
    worker = ControlWorker(
        ("127.0.0.1", port), 1, network_fingerprint([_fake()]),
        connect_timeout_s=10.0,
    )
    with pytest.raises(MultiHostServingError, match="no control traffic"):
        worker.run([_fake()], recv_timeout_s=0.3)
    thread.join(timeout=5)
    accepted["conn"].close()
    listener.close()


def test_heartbeats_keep_idle_worker_alive():
    """An idle worker outlives many multiples of its recv timeout as long as
    heartbeats flow, then exits 0 on the explicit shutdown."""
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, heartbeat_interval_s=0.1
    )
    thread, result = _worker_thread(
        [_fake()], coordinator.port, recv_timeout_s=0.8
    )
    coordinator.accept(network_fingerprint([_fake()]), timeout_s=30.0)
    time.sleep(2.5)  # ~3x the worker timeout: only heartbeats arrive
    coordinator.shutdown()
    thread.join(timeout=10)
    assert result.get("served") == 0, result


def test_daemon_over_multihost_proxies():
    """The full HTTP daemon over proxied networks: requests serve normally,
    a killed worker turns into HTTP 500s (not hangs) and the channel's
    failed event fires — the CLI's signal to stop serving."""
    from gance_tpu_torch.serving import ServingClient, ServingClientError, SynthesisDaemon

    coordinator_net = _fake()
    worker_net = _RecordingFake(
        resolution=16, expected_vector_length=VECTOR_LENGTH
    )
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, ack_timeout_s=5.0,
        heartbeat_interval_s=0.2,
    )
    accept_thread, accept_result = _accept_async(
        coordinator, network_fingerprint([coordinator_net])
    )
    worker = ControlWorker(
        ("127.0.0.1", coordinator.port), 1,
        network_fingerprint([worker_net]), connect_timeout_s=30.0,
    )
    result = {}

    def run():
        try:
            result["served"] = worker.run([worker_net], recv_timeout_s=30.0)
        except BaseException as error:  # noqa: BLE001
            result["error"] = error

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    accept_thread.join(timeout=30)
    assert "error" not in accept_result, accept_result
    proxies = wrap_networks_for_multihost([coordinator_net], coordinator)
    with SynthesisDaemon(proxies, port=0, max_batch=8) as daemon:
        client = ServingClient(f"http://127.0.0.1:{daemon.port}", timeout_s=30.0)
        rng = np.random.RandomState(7)
        z = rng.randn(3, VECTOR_LENGTH).astype(np.float32)
        images = client.synthesize(latents=z)
        np.testing.assert_array_equal(images, coordinator_net.images_generic(z))
        # the worker saw the BUCKETED batch (3 -> 8 rows)
        assert worker_net.device_batches == [("z", (8, VECTOR_LENGTH))]

        # kill the worker mid-serve: requests must fail, not hang
        worker.close()
        thread.join(timeout=10)
        with pytest.raises(ServingClientError) as info:
            client.synthesize(latents=z)
        assert info.value.status == 500
        assert coordinator.failed.wait(timeout=5)
        # the daemon is still answering (the CLI owns the decision to exit)
        assert client.health()["ok"]
    coordinator.close()


def test_hot_rollout_multihost():
    """Zero-downtime model rollout across hosts: /admin/load runs the
    two-phase prepare (completion-acked parse) + commit (receipt-acked
    placement) so workers hold the new slot before any request can route to
    it; dispatches to the new network mirror on the worker's own copy;
    /admin/unload drops the slot everywhere."""
    from gance_tpu_torch.serving import (
        MultiHostNetwork,
        ServingClient,
        ServingClientError,
        SynthesisDaemon,
    )

    coordinator_net = _fake()
    coordinator_net.path = Path("/nets/alpha_net.pkl")
    worker_net = _RecordingFake(resolution=16, expected_vector_length=VECTOR_LENGTH)
    worker_net.path = Path("/nets/alpha_net.pkl")
    worker_loads = []

    def worker_prepare(path, index):
        worker_loads.append(("prepare", path, index))
        return {"parsed": path}

    def worker_commit(staged, path, index):
        assert staged == {"parsed": path}
        worker_loads.append(("commit", path, index))
        loaded = _RecordingFake(
            resolution=16, expected_vector_length=VECTOR_LENGTH
        )
        loaded.path = Path(path)
        return loaded

    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, heartbeat_interval_s=0.2
    )
    result = {}

    def run():
        try:
            result["served"] = run_worker(
                [worker_net], "127.0.0.1", coordinator.port, 1,
                recv_timeout_s=30.0, connect_timeout_s=30.0,
                load_prepare=worker_prepare, load_commit=worker_commit,
            )
        except BaseException as error:  # noqa: BLE001
            result["error"] = error

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    coordinator.accept(network_fingerprint([coordinator_net]), timeout_s=30.0)
    proxies = wrap_networks_for_multihost([coordinator_net], coordinator)

    def network_loader(path, index):
        coordinator.broadcast_load(path, index)
        loaded = _fake()
        loaded.path = Path(path)
        return MultiHostNetwork(loaded, coordinator, index)

    with SynthesisDaemon(
        proxies, port=0, max_batch=8, max_delay_ms=0,
        network_loader=network_loader,
        network_unloader=coordinator.broadcast_unload,
    ) as daemon:
        client = ServingClient(f"http://127.0.0.1:{daemon.port}", timeout_s=30.0)
        loaded = client.load_network("/nets/beta_net.pkl")
        assert loaded["index"] == 1 and loaded["name"] == "beta_net"
        assert worker_loads == [
            ("prepare", "/nets/beta_net.pkl", 1),
            ("commit", "/nets/beta_net.pkl", 1),
        ]

        images = client.synthesize(
            latents=np.zeros((2, VECTOR_LENGTH), np.float32), network="beta_net"
        )
        assert images.shape == (2, 16, 16, 3)

        reply = client.unload_network("beta_net")
        assert reply["drained"] is True
        with pytest.raises(ServingClientError) as info:
            client.synthesize(
                latents=np.zeros((1, VECTOR_LENGTH), np.float32), network=1
            )
        assert info.value.status == 400
    coordinator.shutdown()
    thread.join(timeout=10)
    # one dispatch total (to the hot-loaded net), mirrored on the worker copy
    assert result.get("served") == 1, result
    assert not coordinator.failed.is_set()


def test_worker_prepare_failure_aborts_rollout_and_serving_survives():
    """A worker that cannot parse the pickle fails ONLY the rollout: prepare
    acks the error, the coordinator broadcasts an abort, /admin/load returns
    500 — and the channel stays healthy (prepare is host-side, nothing
    diverged), so existing networks keep serving and shutdown is clean."""
    from gance_tpu_torch.serving import (
        MultiHostNetwork,
        ServingClient,
        ServingClientError,
        SynthesisDaemon,
    )

    coordinator_net = _fake()
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, ack_timeout_s=5.0
    )
    result = {}

    def run():
        try:
            result["served"] = run_worker(
                [_fake()], "127.0.0.1", coordinator.port, 1,
                recv_timeout_s=30.0, connect_timeout_s=30.0,
                load_prepare=lambda path, index: (_ for _ in ()).throw(
                    FileNotFoundError(f"no such pickle: {path}")
                ),
                load_commit=lambda staged, path, index: _fake(),
            )
        except BaseException as error:  # noqa: BLE001
            result["error"] = error

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    coordinator.accept(network_fingerprint([coordinator_net]), timeout_s=30.0)
    proxies = wrap_networks_for_multihost([coordinator_net], coordinator)

    def network_loader(path, index):
        coordinator.broadcast_load(path, index)
        return MultiHostNetwork(_fake(), coordinator, index)

    with SynthesisDaemon(
        proxies, port=0, max_batch=8, max_delay_ms=0,
        network_loader=network_loader,
    ) as daemon:
        client = ServingClient(f"http://127.0.0.1:{daemon.port}", timeout_s=30.0)
        with pytest.raises(ServingClientError) as info:
            client.load_network("/nets/missing_net.pkl")
        assert info.value.status == 500
        assert "no such pickle" in info.value.message
        # the rollout failed; the FLEET did not
        assert not coordinator.failed.is_set()
        assert len(daemon.networks) == 1  # no half-loaded slot
        images = client.synthesize(
            latents=np.zeros((2, VECTOR_LENGTH), np.float32)
        )
        assert images.shape == (2, 16, 16, 3)
    coordinator.shutdown()
    thread.join(timeout=10)
    assert result.get("served") == 1, result
    assert not coordinator.failed.is_set()


def test_audio_endpoint_mirrors_over_multihost(tmp_path):
    """POST /synthesize_audio through the multi-host proxies: every
    per-network run the server dispatches is broadcast to the worker (same
    lanes, same bucketed shapes), so the audio path needs no special-casing
    to run multi-host."""
    from gance_tpu_torch.audio.io import fabricate_percussive_wav
    from gance_tpu_torch.serving import ServingClient, SynthesisDaemon

    wav = fabricate_percussive_wav(tmp_path / "clip.wav", seconds=1.0).read_bytes()
    # 512-latent fakes: the RMS hop (512) aligns index count with frame count
    coordinator_nets = [
        FakeSynthesisNetwork(resolution=16, expected_vector_length=512)
        for _ in range(2)
    ]
    worker_nets = [
        _RecordingFake(resolution=16, expected_vector_length=512) for _ in range(2)
    ]
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, heartbeat_interval_s=0.2
    )
    result = {}

    def run():
        try:
            result["served"] = run_worker(
                worker_nets, "127.0.0.1", coordinator.port, 1,
                recv_timeout_s=30.0, connect_timeout_s=30.0,
            )
        except BaseException as error:  # noqa: BLE001
            result["error"] = error

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    coordinator.accept(network_fingerprint(coordinator_nets), timeout_s=30.0)
    proxies = wrap_networks_for_multihost(coordinator_nets, coordinator)
    with SynthesisDaemon(proxies, port=0, max_batch=8, max_delay_ms=0) as daemon:
        client = ServingClient(f"http://127.0.0.1:{daemon.port}", timeout_s=60.0)
        plan = client.synthesize_audio(wav, fps=15.0, plan=True)
        images = client.synthesize_audio(wav, fps=15.0)
        assert images.shape == (plan["frames"], 16, 16, 3)
    coordinator.shutdown()
    thread.join(timeout=10)
    # the worker mirrored every device dispatch: one per max_batch-sized
    # slice of each per-network group
    import math

    expected = sum(
        math.ceil(plan["indices"].count(index) / 8)
        for index in set(plan["indices"])
    )
    assert result.get("served") == expected, (result, plan["indices"])
    mirrored = sum(shape[0] for _kind, shape in worker_nets[0].device_batches) + sum(
        shape[0] for _kind, shape in worker_nets[1].device_batches
    )
    assert mirrored >= plan["frames"]  # bucketed shapes pad up


def test_projection_blend_mirrors_over_multihost(tmp_path):
    """The FLAGSHIP transform (projection-file blend via /synthesize_audio)
    through the multi-host proxies: registration is coordinator-side host
    state (no broadcast needed), and the w+ dispatches ride the same
    "matrices" control frames as any dlatents request — the worker renders
    identical bucketed batches."""
    from gance_tpu_torch.audio.io import fabricate_percussive_wav
    from gance_tpu_torch.serving import ServingClient, SynthesisDaemon

    wav = fabricate_percussive_wav(tmp_path / "clip.wav", seconds=1.0).read_bytes()
    coordinator_nets = [
        FakeSynthesisNetwork(resolution=16, expected_vector_length=512)
        for _ in range(2)
    ]
    worker_nets = [
        _RecordingFake(resolution=16, expected_vector_length=512) for _ in range(2)
    ]
    rows = int(coordinator_nets[0].config.num_style_rows)
    rng = np.random.RandomState(5)
    latents = np.tile(rng.randn(9, 1, 512).astype(np.float32), (1, rows, 1))
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, heartbeat_interval_s=0.2
    )
    result = {}

    def run():
        try:
            result["served"] = run_worker(
                worker_nets, "127.0.0.1", coordinator.port, 1,
                recv_timeout_s=30.0, connect_timeout_s=30.0,
            )
        except BaseException as error:  # noqa: BLE001
            result["error"] = error

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    coordinator.accept(network_fingerprint(coordinator_nets), timeout_s=30.0)
    proxies = wrap_networks_for_multihost(coordinator_nets, coordinator)
    with SynthesisDaemon(proxies, port=0, max_batch=8, max_delay_ms=0) as daemon:
        client = ServingClient(f"http://127.0.0.1:{daemon.port}", timeout_s=60.0)
        client.register_projection(
            final_latents=latents, projection_fps=15.0, name="clip"
        )
        plan = client.synthesize_audio(
            wav, fps=15.0, projection="clip", blend_depth=2, plan=True
        )
        assert plan["projection"] == "clip"
        images = client.synthesize_audio(
            wav, fps=15.0, projection="clip", blend_depth=2
        )
        assert images.shape == (plan["frames"], 16, 16, 3)
    coordinator.shutdown()
    thread.join(timeout=10)
    assert "error" not in result, result
    # every mirrored dispatch was a w+ batch carrying the full row stack
    mirrored = [
        shape
        for worker in worker_nets
        for kind, shape in worker.device_batches
        if kind == "w+"
    ]
    assert mirrored and all(shape[1:] == (rows, 512) for shape in mirrored)
    assert sum(shape[0] for shape in mirrored) >= plan["frames"]


def test_unauthenticated_peers_dropped_and_accept_continues():
    """Scanners / stray clients / wrong-token peers are dropped at the
    challenge handshake — pickle never parses their bytes — and the listener
    keeps waiting for the real workers instead of aborting startup."""
    coordinator = ControlCoordinator(num_workers=1, bind_host="127.0.0.1", port=0)
    fingerprint = network_fingerprint([_fake()])
    accept_thread, accept_result = _accept_async(coordinator, fingerprint)

    # peer 1: connects and immediately closes (a TCP health probe)
    probe = socket.create_connection(("127.0.0.1", coordinator.port))
    probe.close()
    # peer 2: answers the challenge with a wrong-token digest + garbage nonce
    wrong = socket.create_connection(("127.0.0.1", coordinator.port), timeout=10.0)
    wrong.settimeout(10.0)
    wrong.recv(64)  # magic + nonce
    wrong.sendall(b"\x00" * 64)

    # the REAL worker connects after the noise; accept must still succeed
    thread, result = _worker_thread([_fake()], coordinator.port)
    accept_thread.join(timeout=30)
    assert not accept_thread.is_alive() and "error" not in accept_result, (
        accept_result
    )
    # peer 2 was rejected: its socket is closed by the coordinator
    wrong.settimeout(5.0)
    assert wrong.recv(1) == b""
    wrong.close()
    coordinator.shutdown()
    thread.join(timeout=10)
    assert result.get("served") == 0, result


def test_frames_reject_forbidden_pickle_globals():
    """Defense in depth behind the handshake: a frame whose pickle references
    a non-allowlisted global (the classic __reduce__ RCE shape) is refused at
    name-resolution time, before any code could run."""
    import io as _io

    from gance_tpu_torch.serving import multihost as mh

    payload = pickle.dumps({"type": "dispatch", "rows": np.zeros((2, 4))})
    frame = _io.BytesIO(payload)
    assert mh._RestrictedUnpickler(frame).load()["type"] == "dispatch"

    evil = pickle.dumps(getattr)  # any non-numpy global stands in for a payload
    with pytest.raises(MultiHostServingError, match="forbidden global"):
        mh._RestrictedUnpickler(_io.BytesIO(evil)).load()


def test_heartbeats_flow_during_slow_prepare():
    """THE multi-host rollout liveness property: while one worker's hot-load
    prepare grinds (pickle parse, up to minutes), workers that acked early
    sit idle in recv — heartbeats must keep flowing to them or they declare
    the coordinator dead and the whole deployment dies on a routine rollout.
    Worker A's recv timeout (0.8s) is far below worker B's prepare time (2s):
    without beats during the broadcast, A exits and the commit breaks."""
    fast_loads = []

    def fast_prepare(path, index):
        fast_loads.append(("prepare", path, index))
        return "staged"

    slow_started = threading.Event()

    def slow_prepare(path, index):
        slow_started.set()
        time.sleep(2.0)
        return "staged"

    def commit(staged, path, index):
        loaded = _fake()
        loaded.path = Path(path)
        return loaded

    coordinator = ControlCoordinator(
        num_workers=2, bind_host="127.0.0.1", port=0,
        heartbeat_interval_s=0.2,
    )
    results = []
    threads = []
    for process_id, prepare, timeout in (
        (1, fast_prepare, 0.8),  # the canary: dies without beats
        (2, slow_prepare, 30.0),
    ):
        result = {}

        def target(prepare=prepare, timeout=timeout, result=result, pid=process_id):
            try:
                result["served"] = run_worker(
                    [_fake()], "127.0.0.1", coordinator.port, pid,
                    recv_timeout_s=timeout, connect_timeout_s=30.0,
                    load_prepare=prepare, load_commit=commit,
                )
            except BaseException as error:  # noqa: BLE001
                result["error"] = error

        thread = threading.Thread(target=target, daemon=True)
        thread.start()
        threads.append(thread)
        results.append(result)
    coordinator.accept(network_fingerprint([_fake()]), timeout_s=30.0)

    coordinator.broadcast_load("/nets/rollout_net.pkl", 1)
    assert slow_started.is_set()
    assert not coordinator.failed.is_set()
    assert fast_loads == [("prepare", "/nets/rollout_net.pkl", 1)]
    # both workers committed slot 1: a dispatch to it mirrors everywhere
    coordinator.broadcast_dispatch(1, "z", np.zeros((2, VECTOR_LENGTH), np.float32))
    coordinator.shutdown()
    for thread, result in zip(threads, results):
        thread.join(timeout=10)
        assert result.get("served") == 1, result


def test_unload_out_of_range_latches_channel_broken():
    """An unload for a slot the worker doesn't hold means the fleets' slot
    tables diverged: the worker error-acks (latching the channel) instead of
    silently keeping memory it was told to free."""
    coordinator = ControlCoordinator(
        num_workers=1, bind_host="127.0.0.1", port=0, ack_timeout_s=5.0
    )
    thread, result = _worker_thread([_fake()], coordinator.port)
    coordinator.accept(network_fingerprint([_fake()]), timeout_s=30.0)
    with pytest.raises(MultiHostServingError, match="out of range"):
        coordinator.broadcast_unload(5)
    assert coordinator.failed.is_set()
    thread.join(timeout=10)
    assert isinstance(result.get("error"), MultiHostServingError)


def test_coordinator_fail_latches_channel():
    """fail() (the coordinator-side commit-failure path in cli/serve.py)
    latches the channel broken so every later dispatch fails fast instead of
    serving against diverged slot tables."""
    coordinator = ControlCoordinator(num_workers=1, bind_host="127.0.0.1", port=0)
    thread, result = _worker_thread([_fake()], coordinator.port)
    coordinator.accept(network_fingerprint([_fake()]), timeout_s=30.0)
    coordinator.fail("coordinator-side commit failed")
    assert coordinator.failed.is_set()
    with pytest.raises(MultiHostServingError, match="broken"):
        coordinator.broadcast_dispatch(
            0, "z", np.zeros((1, VECTOR_LENGTH), np.float32)
        )
    thread.join(timeout=10)  # its socket was closed; the worker exits loudly
    assert "error" in result


def test_serve_cli_rejects_partial_dist_triple(tmp_path):
    """--dist-* is all-or-none on the serve CLI, the same contract as the
    render CLIs (cli/common.py maybe_initialize_distributed)."""
    from click.testing import CliRunner

    from gance_tpu_torch.cli.serve import build_cli

    net = tmp_path / "net.pkl"
    net.write_bytes(b"never parsed")
    result = CliRunner().invoke(
        build_cli(),
        ["--network-path", str(net), "--dist-coordinator", "localhost:1234", "--device", "cpu"],
    )
    assert result.exit_code != 0
    assert "must be given together" in result.output


def test_daemon_two_process_matches_single_process(tmp_path, monkeypatch):
    """
    The real online daemon over a mesh spanning two gloo processes of two CPU
    slots each (data 2 x model 2, the model axis inside each process, the
    large weights sharded by a lowered threshold): the control channel, HTTP
    requests (z and w+) and a hot load mid-serve, against one process
    serving the same requests over a data 2 x model 2 mesh of its own: equal
    bit for bit.
    """
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig, init_generator_params
    from gance_tpu_torch.parallel import mesh as port_mesh
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork
    from tests.torch_parallel_worker import free_port, run_workers

    kw = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
              mapping_layers=2, mapping_fmaps=16)
    model = GeneratorConfig(**kw)
    save_generator_pickle(init_generator_params(0, model), tmp_path / "net.pkl")
    save_generator_pickle(init_generator_params(1, model), tmp_path / "net2.pkl")
    rng = np.random.RandomState(11)
    z = rng.randn(5, 16).astype(np.float32)
    w = rng.randn(3, int(model.num_style_rows), 16).astype(np.float32)
    inputs = dict(dir=str(tmp_path), z=z, w=w, control_port=free_port(), data_parallel=2,
                  min_sharded=1024)
    outs = run_workers("daemon", inputs, tmp_path, world=2, cpu_devices=2, timeout=300)
    assert outs[1]["served"] == 3  # z, w+ and the hot-loaded network's z
    assert outs[0]["mesh"] == outs[1]["mesh"] == {"data": 2, "model": 2}
    assert outs[0]["sharded"] > 0

    monkeypatch.setattr(port_mesh, "_MIN_SHARDED_PARAM", 1024)
    mesh = port_mesh.create_mesh(devices=["cpu"] * 4, data_parallel=2)
    network = SynthesisNetwork.from_pkl(tmp_path / "net.pkl", mesh=mesh, device="cpu")
    np.testing.assert_array_equal(outs[0]["out_z"], network.images_from_vectors(z))
    np.testing.assert_array_equal(outs[0]["out_w"], network.images_from_matrices(w))
    hot = SynthesisNetwork.from_pkl(tmp_path / "net2.pkl", mesh=mesh, device="cpu")
    np.testing.assert_array_equal(outs[0]["out_z2"], hot.images_from_vectors(z))


def test_serve_cli_two_processes_serve_and_drain(tmp_path):
    """The port's serve CLI as two --dist-* processes on the CPU (gloo, one
    slot each: data 2): rank 0 prints its URL and serves HTTP, rank 1 binds
    nothing and mirrors each dispatch; the frames equal one process's; a
    SIGTERM drains rank 0, whose shutdown ends rank 1, and both exit 0."""
    import queue
    import re
    import signal
    import subprocess
    import sys

    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig, init_generator_params
    from gance_tpu_torch.serving import ServingClient
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork
    from tests.torch_parallel_worker import child_env, free_port

    config = GeneratorConfig(resolution=16, fmap_base=256, fmap_max=32, latent_size=16,
                             dlatent_size=16, mapping_layers=2, mapping_fmaps=16)
    net = tmp_path / "net.pkl"
    save_generator_pickle(init_generator_params(3, config), net)
    dist_port, control_port = free_port(), free_port()
    env = dict(child_env(), GANCE_TPU_SERVE_TOKEN="test-token")
    root = Path(__file__).resolve().parents[1]
    children = [subprocess.Popen(
        [sys.executable, "-m", "gance_tpu_torch.cli.serve", "--network-path", str(net),
         "--port", "0", "--device", "cpu", "--warmup", "none", "--max-batch", "8",
         "--dist-coordinator", f"localhost:{dist_port}", "--dist-num-processes", "2",
         "--dist-process-id", str(rank), "--control-port", str(control_port)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in children[0].stdout],
                     daemon=True).start()
    try:
        url, deadline = None, time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            try:
                found = re.search(r"on (http://[\d.]+:\d+)", lines.get(timeout=1.0))
            except queue.Empty:
                continue
            url = found.group(1) if found else None
        assert url is not None, "rank 0 never printed its URL"
        z = np.random.RandomState(12).randn(3, 16).astype(np.float32)
        images = ServingClient(url, timeout_s=60.0).synthesize(latents=z)
        want = SynthesisNetwork.from_pkl(net, device="cpu").images_from_vectors(z)
        assert images.shape == want.shape
        assert int(np.abs(images.astype(int) - want.astype(int)).max()) <= 1
        children[0].send_signal(signal.SIGTERM)
        codes = [child.wait(timeout=60) for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    rest = children[1].stdout.read()
    assert codes == [0, 0], rest[-3000:]
    assert "clean shutdown after 1 dispatches" in rest
