"""
The port's HTTP daemon (gance_tpu_torch/serving/daemon.py) against
gance_tpu's, on the CPU, the same request to both: JAX's tiny serving
generator (tests/test_serving.py's, 16px, fmap_base 256, fmap_max 32, latent
64), its weights carried to the port by `models/convert.py`. Frames within 1
uint8 step of JAX's on at least 99.9% of pixels (fp32 sums in another order
can cross a rounding boundary), and at least 90% equal; the error statuses,
the /healthz and /stats keys and the /metrics names as JAX's; each package's
client against the other's daemon; the drain (in process, and the serve CLI
in a child process under SIGTERM); hot load and unload. Three departures are
shown beside JAX's behaviour: the byte bound on registered projections, a
drain that waits for responses still being written, and the queue-wait
quantiles in /stats and /metrics.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.models.stylegan2 import GeneratorConfig as JaxConfig  # noqa: E402
from gance_tpu.models.stylegan2 import init_generator_params  # noqa: E402
from gance_tpu.serving import client as jax_client  # noqa: E402
from gance_tpu.serving import daemon as jax_daemon  # noqa: E402
from gance_tpu.synthesis import runtime as jax_rt  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.models.stylegan2 import GeneratorConfig as PortConfig  # noqa: E402
from gance_tpu_torch.serving import client as port_client  # noqa: E402
from gance_tpu_torch.serving import daemon as port_daemon  # noqa: E402
from gance_tpu_torch.synthesis import runtime as port_rt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=64, dlatent_size=64,
            mapping_layers=2, mapping_fmaps=64)
VECTOR = 64
# the two packages' frames: within 1 step on this share of pixels, equal on this share
WITHIN_ONE_STEP, EQUAL = 0.999, 0.9


def assert_frames_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    steps = np.abs(got.astype(int) - want.astype(int))
    assert float(np.mean(steps <= 1)) >= WITHIN_ONE_STEP, int(steps.max())
    assert float(np.mean(steps == 0)) >= EQUAL


@pytest.fixture(scope="module")
def networks():
    params = jax.tree_util.tree_map(np.asarray,
                                    init_generator_params(jax.random.PRNGKey(0), JaxConfig(**TINY)))
    jax_net = jax_rt.SynthesisNetwork(params=params, config=JaxConfig(**TINY))
    port_net = port_rt.SynthesisNetwork(params=params_from_reference(params),
                                        config=PortConfig(**TINY), device="cpu")
    return jax_net, port_net


@pytest.fixture(scope="module")
def daemons(networks):
    jax_net, port_net = networks
    with jax_daemon.SynthesisDaemon(jax_net, port=0, max_batch=8, max_delay_ms=2) as jd, \
            port_daemon.SynthesisDaemon(port_net, port=0, max_batch=8, max_delay_ms=2) as pd:
        yield {"jax": jd, "port": pd}


def call(daemon, path: str, body=None, raw: bytes = None):
    """(status, body bytes, headers) of one request; GET when there is no body."""
    url = f"http://127.0.0.1:{daemon.port}{path}"
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    request = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=120) as response:
            return response.status, response.read(), dict(response.headers)
    except urllib.error.HTTPError as error:
        return error.code, error.read(), dict(error.headers)


REQUESTS = {
    "seeds": {"seeds": [0, 5, 11]},
    "count": {"count": 5, "seed": 3},
    "latents": {"latents": np.random.RandomState(1).randn(4, VECTOR).astype(np.float32).tolist()},
    "dlatents": {"dlatents": np.random.RandomState(2).randn(2, 6, VECTOR).astype(
        np.float32).tolist()},
    "network by name": {"seeds": [4], "network": "network_0"},
}


@pytest.mark.parametrize("source", sorted(REQUESTS))
def test_synthesize_matches_jax(daemons, source):
    answers = {pkg: call(d, "/synthesize", REQUESTS[source]) for pkg, d in daemons.items()}
    for status, _body, _headers in answers.values():
        assert status == 200
    got, want = (np.load(io.BytesIO(answers[pkg][1])) for pkg in ("port", "jax"))
    assert answers["port"][2]["X-Gance-Shape"] == answers["jax"][2]["X-Gance-Shape"]
    assert_frames_close(got, want)


ERRORS = {
    "no source": ("/synthesize", {}),
    "two sources": ("/synthesize", {"seeds": [1], "count": 2}),
    "latent length": ("/synthesize", {"latents": [[0.0] * (VECTOR - 1)]}),
    "style rows": ("/synthesize", {"dlatents": [[[0.0] * VECTOR] * 3]}),
    "empty seeds": ("/synthesize", {"seeds": []}),
    "zero count": ("/synthesize", {"count": 0}),
    "frame cap": ("/synthesize", {"count": 4097}),
    "unknown format": ("/synthesize", {"seeds": [1], "format": "gif"}),
    "png of two": ("/synthesize", {"seeds": [1, 2], "format": "png"}),
    "avi fps": ("/synthesize", {"seeds": [1], "format": "avi", "fps": 0}),
    "unknown network": ("/synthesize", {"seeds": [1], "network": "nope"}),
    "network index": ("/synthesize", {"seeds": [1], "network": 5}),
    "network bool": ("/synthesize", {"seeds": [1], "network": True}),
    "not an object": ("/synthesize", [1]),
    "no route (POST)": ("/nope", {"seeds": [1]}),
    "no route (GET)": ("/nope", None),
    "no loader": ("/admin/load", {"path": "/x.pkl"}),
    "unload identity": ("/admin/unload", {"network": 0}),
    "audio without wav": ("/synthesize_audio", {"fps": 30}),
    "audio format": ("/synthesize_audio", {"wav_base64": "AAAA", "format": "gif"}),
    "audio bad base64": ("/synthesize_audio", {"wav_base64": "!!"}),
    "register nothing": ("/admin/register_projection", {}),
    "unregister unknown": ("/admin/unregister_projection", {"name": "x"}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_statuses_match_jax(daemons, case):
    path, body = ERRORS[case]
    statuses = {pkg: call(d, path, body)[0] for pkg, d in daemons.items()}
    assert statuses["port"] == statuses["jax"] != 200


def test_malformed_body_status_matches_jax(daemons):
    statuses = {pkg: call(d, "/synthesize", raw=b"{")[0] for pkg, d in daemons.items()}
    assert statuses["port"] == statuses["jax"] == 400


# the port's /stats and /metrics fields that JAX's daemon lacks
PORT_ONLY_STATS = {"queue_wait_p50_ms", "queue_wait_p95_ms"}
PORT_ONLY_METRICS = {"gance_serving_queue_wait_p50_seconds",
                     "gance_serving_queue_wait_p95_seconds"}


def test_healthz_stats_and_metrics_have_jax_keys(daemons):
    for path in ("/healthz", "/stats"):
        got, want = (json.loads(call(daemons[pkg], path)[1]) for pkg in ("port", "jax"))
        # the port adds its queue-wait quantiles exactly where latency is reported
        assert set(got) == set(want) | (PORT_ONLY_STATS if "latency_p50_ms" in want else set())
    health = json.loads(call(daemons["port"], "/healthz")[1])
    import gance_tpu_torch

    assert health["version"] == gance_tpu_torch.__version__ and health["ok"]

    def names(pkg):
        text = call(daemons[pkg], "/metrics")[1].decode()
        return {line.rsplit(" ", 1)[0].split("{")[0] for line in text.splitlines()
                if line and not line.startswith("#")}

    want = names("jax")
    served = "gance_serving_latency_p50_seconds" in want
    assert names("port") == want | (PORT_ONLY_METRICS if served else set())


def test_rows_and_frame_caps_match_jax():
    for payload in ({"seeds": [3, 9]}, {"count": 4, "seed": 7}):
        np.testing.assert_array_equal(port_daemon._rows_from_request(payload, VECTOR, 10),
                                      jax_daemon._rows_from_request(payload, VECTOR, 10))
    for resolution in (0, 16, 256, 1024):
        assert port_daemon.max_frames_for(resolution) == jax_daemon.max_frames_for(resolution)


@pytest.mark.parametrize("client_pkg,daemon_pkg", [("port", "jax"), ("jax", "port")])
def test_client_wire_compatibility(daemons, networks, client_pkg, daemon_pkg):
    import zipfile

    import cv2

    module = port_client if client_pkg == "port" else jax_client
    client = module.ServingClient(f"http://127.0.0.1:{daemons[daemon_pkg].port}")
    network = networks[1] if daemon_pkg == "port" else networks[0]
    assert client.health()["vector_length"] == VECTOR
    images = client.synthesize(seeds=[1, 2])
    z = np.stack([np.random.RandomState(s).randn(VECTOR) for s in (1, 2)]).astype(np.float32)
    direct = network.images_from_vectors(z)
    np.testing.assert_array_equal(images, direct)
    png = cv2.imdecode(np.frombuffer(client.synthesize_png(seeds=[1]), np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(cv2.cvtColor(png, cv2.COLOR_BGR2RGB), direct[0])
    with zipfile.ZipFile(io.BytesIO(client.synthesize_compressed(seeds=[1, 2]))) as archive:
        assert sorted(archive.namelist()) == ["frame_000000.png", "frame_000001.png"]
    with pytest.raises(module.ServingClientError) as info:
        client.synthesize(latents=np.zeros((1, VECTOR + 1), np.float32))
    assert info.value.status == 400 and "latent" in info.value.message
    assert client.stats()["requests"] >= 3


def slow_fake(runtime, release: threading.Event):
    class Slow(runtime.FakeSynthesisNetwork):
        def device_images_generic(self, batch):
            release.wait(timeout=30)
            return self._render(np.asarray(batch))

    return Slow(resolution=16, expected_vector_length=32)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_drain_finishes_in_flight_and_refuses_new(pkg):
    daemon_mod, runtime, client_mod = {
        "jax": (jax_daemon, jax_rt, jax_client), "port": (port_daemon, port_rt, port_client)}[pkg]
    release = threading.Event()
    with daemon_mod.SynthesisDaemon(slow_fake(runtime, release), port=0, max_batch=8,
                                    max_delay_ms=0) as daemon:
        url = f"http://127.0.0.1:{daemon.port}"
        results = {}
        inflight = threading.Thread(target=lambda: results.setdefault(
            "images", client_mod.ServingClient(url).synthesize(latents=np.zeros((2, 32)))))
        inflight.start()
        for _ in range(500):
            if daemon.batcher.live_requests():
                break
            time.sleep(0.01)
        drained = {}
        drainer = threading.Thread(target=lambda: drained.setdefault("idle",
                                                                     daemon.drain(timeout_s=30)))
        drainer.start()
        for _ in range(500):
            if daemon.draining:
                break
            time.sleep(0.01)
        with pytest.raises(client_mod.ServingClientError) as info:
            client_mod.ServingClient(url).synthesize(latents=np.zeros((1, 32)))
        assert info.value.status == 503 and "draining" in info.value.message
        health = client_mod.ServingClient(url).health()
        assert health["draining"] is True and health["ok"] is False
        release.set()
        inflight.join(timeout=30)
        drainer.join(timeout=30)
        assert results["images"].shape == (2, 16, 16, 3) and drained["idle"] is True


def test_requests_refused_during_drain_do_not_hold_it(monkeypatch):
    """Requests turned away with 503 while draining are not counted as being
    answered, so clients that keep retrying cannot hold the drain open: each
    refusal sees only the one request that was in flight when drain began."""
    release = threading.Event()
    with port_daemon.SynthesisDaemon(slow_fake(port_rt, release), port=0, max_batch=8,
                                     max_delay_ms=0) as daemon:
        handler = daemon._server.RequestHandlerClass
        reply_json = handler._reply_json
        counted_at_refusal = []

        def spy(self, status, payload):
            if status == 503:
                counted_at_refusal.append(daemon._responding)
            return reply_json(self, status, payload)

        monkeypatch.setattr(handler, "_reply_json", spy)
        inflight = threading.Thread(target=lambda: call(daemon, "/synthesize",
                                                        {"latents": [[0.0] * 32]}))
        inflight.start()
        for _ in range(500):
            if daemon.batcher.live_requests():
                break
            time.sleep(0.01)
        drained = {}
        drainer = threading.Thread(target=lambda: drained.setdefault(
            "done", daemon.drain(timeout_s=30)))
        drainer.start()
        for _ in range(500):
            if daemon.draining:
                break
            time.sleep(0.01)
        stop = threading.Event()
        statuses = []

        def retry():
            while not stop.is_set():
                statuses.append(call(daemon, "/synthesize", {"latents": [[0.0] * 32]})[0])

        retriers = [threading.Thread(target=retry) for _ in range(4)]
        for thread in retriers:
            thread.start()
        time.sleep(0.3)
        release.set()
        drainer.join(timeout=10)
        stop.set()
        for thread in retriers + [inflight]:
            thread.join(timeout=30)
        assert drained == {"done": True} and statuses and set(statuses) == {503}
        assert 1 in counted_at_refusal and set(counted_at_refusal) <= {0, 1}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_failed_dispatch_is_500(pkg):
    daemon_mod, runtime = {"jax": (jax_daemon, jax_rt), "port": (port_daemon, port_rt)}[pkg]

    class Broken(runtime.FakeSynthesisNetwork):
        def device_images_generic(self, batch):
            raise RuntimeError("device failure")

    with daemon_mod.SynthesisDaemon(Broken(resolution=8, expected_vector_length=32), port=0,
                                    max_batch=8, max_delay_ms=0) as daemon:
        status, body, _ = call(daemon, "/synthesize", {"latents": [[0.0] * 32]})
        assert status == 500 and "device failure" in json.loads(body)["error"]
        assert daemon.batcher.stats()["errors"] == 1


def test_drain_waits_for_responses_being_written(monkeypatch):
    """Departure: the port's drain returns after the responses are written;
    JAX's returns once the batcher is idle, with a response still encoding."""
    outcomes = {}
    for pkg, daemon_mod, runtime in (("jax", jax_daemon, jax_rt), ("port", port_daemon, port_rt)):
        encode = daemon_mod._encode_images

        def slow_encode(*args, _encode=encode, **kwargs):
            time.sleep(1.0)
            return _encode(*args, **kwargs)

        monkeypatch.setattr(daemon_mod, "_encode_images", slow_encode)
        network = runtime.FakeSynthesisNetwork(resolution=8, expected_vector_length=32)
        with daemon_mod.SynthesisDaemon(network, port=0, max_batch=8, max_delay_ms=0) as daemon:
            answered = threading.Event()
            thread = threading.Thread(target=lambda: (call(daemon, "/synthesize", {"count": 2}),
                                                      answered.set()))
            thread.start()
            for _ in range(500):
                if daemon.batcher.stats()["frames"]:
                    break
                time.sleep(0.01)
            assert daemon.drain(timeout_s=30)
            outcomes[pkg] = answered.is_set()
            thread.join(timeout=30)
    assert outcomes == {"jax": False, "port": True}


def test_projection_byte_bound(daemons, monkeypatch):
    """Departure: registered projections are held to a byte bound (400 past
    it); JAX registers without one."""
    latents = np.tile(np.random.RandomState(3).randn(40, 1, VECTOR).astype(np.float32),
                      (1, 6, 1))  # 61 440 bytes
    body = {"final_latents_base64": None, "projection_fps": 15.0, "name": "big"}
    buffer = io.BytesIO()
    np.save(buffer, latents)
    import base64

    body["final_latents_base64"] = base64.b64encode(buffer.getvalue()).decode()
    port = daemons["port"]
    monkeypatch.setattr(port_daemon, "MAX_PROJECTION_BYTES", 100_000)  # room for one
    try:
        assert call(daemons["jax"], "/admin/register_projection", body)[0] == 200
        assert call(port, "/admin/register_projection", body)[0] == 200
        # replacing a handle counts its new bytes only
        assert call(port, "/admin/register_projection", body)[0] == 200
        status, reply, _ = call(port, "/admin/register_projection", dict(body, name="second"))
        assert status == 400 and "bound" in json.loads(reply)["error"]
        assert call(daemons["jax"], "/admin/register_projection",
                    dict(body, name="second"))[0] == 200
        listed = json.loads(call(port, "/projections")[1])["projections"]
        assert [p["name"] for p in listed] == ["big"]
    finally:
        for pkg, daemon in daemons.items():
            for name in ("big", "second"):
                call(daemon, "/admin/unregister_projection", {"name": name})


def fake_loader(runtime):
    def load(path, _index=None):
        fake = runtime.FakeSynthesisNetwork(resolution=16, expected_vector_length=32)
        fake.path = Path(path)
        return fake

    return load


def test_hot_load_and_unload_match_jax():
    replies = {}
    for pkg, daemon_mod, runtime, client_mod in (
            ("jax", jax_daemon, jax_rt, jax_client), ("port", port_daemon, port_rt, port_client)):
        first = fake_loader(runtime)("/nets/alpha_net.pkl")
        with daemon_mod.SynthesisDaemon(first, port=0, max_batch=8, max_delay_ms=0,
                                        network_loader=fake_loader(runtime)) as daemon:
            client = client_mod.ServingClient(f"http://127.0.0.1:{daemon.port}")
            record = [client.load_network("/nets/beta_net.pkl")]
            record.append(client.synthesize(latents=np.ones((2, 32)), network="beta_net").tolist())
            record.append(client.unload_network("beta_net"))
            for selector in (1, "beta_net"):
                with pytest.raises(client_mod.ServingClientError) as info:
                    client.synthesize(latents=np.ones((1, 32)), network=selector)
                record.append((info.value.status, info.value.message))
            record.append(client.health()["networks"])
            record.append(client.load_network("/nets/beta_net.pkl"))
            record.append(daemon.batcher.networks[1] is None)
        replies[pkg] = record
    assert replies["port"] == replies["jax"]


def test_serve_cli_child_serves_and_drains_on_sigterm(tmp_path, networks):
    """`python -m gance_tpu_torch.cli.serve --device cpu` over a pickle: it
    serves the pickle's frames, and SIGTERM drains it to exit code 0."""
    from gance_tpu.models.pickle_loader import save_generator_pickle

    path = tmp_path / "tiny_net.pkl"
    save_generator_pickle(networks[0].params, path)
    log = tmp_path / "serve.log"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with open(log, "wb") as output:
        child = subprocess.Popen(
            [sys.executable, "-m", "gance_tpu_torch.cli.serve", "--network-path", str(path),
             "--port", "0", "--device", "cpu", "--max-batch", "8", "--warmup", "all",
             "--warmup-audio", "4"],
            cwd=tmp_path, env=env, stdout=output, stderr=subprocess.STDOUT)
    try:
        url = None
        for _ in range(1200):
            lines = [line for line in log.read_text().splitlines() if line.startswith("serving ")]
            if lines:
                url = lines[0].split(" on ", 1)[1].split(" ", 1)[0]
                break
            assert child.poll() is None, log.read_text()[-3000:]
            time.sleep(0.05)
        assert url is not None
        client = port_client.ServingClient(url)
        assert client.health()["resolution"] == 16
        images = client.synthesize(seeds=[1, 2])
        z = np.stack([np.random.RandomState(s).randn(VECTOR) for s in (1, 2)]).astype(np.float32)
        assert_frames_close(images, networks[1].images_from_vectors(z))
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
