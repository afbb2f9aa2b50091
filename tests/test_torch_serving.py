"""
The port's dynamic batcher (gance_tpu_torch/serving/batcher.py) against
gance_tpu's, on the CPU: the bucket rule and the warm set equal JAX's over a
grid, and each behaviour scenario (coalescing, lane separation, partial
consume, cancel before and in flight, retire, close) runs on both packages'
batchers over their own FakeSynthesisNetworks with a gate on the device call,
which makes the batch composition deterministic; the scenario's record (the
device batches' shapes, the results, the errors, the live counts) must be
equal. Then the batcher over a real tiny network against direct synthesis,
the serve CLI's options and its multi-device refusals, and the serving timing
tool at 16px.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gance_tpu.serving import batcher as jax_batcher  # noqa: E402
from gance_tpu.synthesis import runtime as jax_rt  # noqa: E402
from gance_tpu_torch.serving import batcher as port_batcher  # noqa: E402
from gance_tpu_torch.synthesis import runtime as port_rt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (jax_batcher, jax_rt), "port": (port_batcher, port_rt)}
VECTOR = 32


@pytest.mark.parametrize("max_batch,multiple", [(8, 8), (48, 8), (64, 8), (48, 1), (6, 1),
                                                (40, 4)])
def test_bucket_rows_and_warmup_sizes_match_jax(max_batch, multiple):
    for real in range(1, 2 * max_batch + 2):
        got = port_batcher.bucket_rows(real, max_batch, multiple)
        assert got == jax_batcher.bucket_rows(real, max_batch, multiple)
        assert got == port_rt._bucket_size(real, max_batch, multiple)
        assert got in port_batcher.warmup_batch_sizes(max_batch, multiple)
    assert port_batcher.warmup_batch_sizes(max_batch, multiple) == \
        jax_batcher.warmup_batch_sizes(max_batch, multiple)


def test_default_max_batch_matches_jax(monkeypatch):
    assert port_batcher.default_max_batch() == jax_batcher.default_max_batch() == 48
    monkeypatch.setenv("GANCE_TPU_SERVE_BATCH", "16")
    assert port_batcher.default_max_batch() == jax_batcher.default_max_batch() == 16


def gated_fake(runtime, resolution: int = 8):
    """A fake of `runtime`'s package that records every device batch and holds
    its first call until `gate` is set (`entered` fires inside that call)."""

    class Gated(runtime.FakeSynthesisNetwork):
        def __init__(self):
            super().__init__(resolution=resolution, expected_vector_length=VECTOR)
            self.batches, self.gate, self.entered = [], threading.Event(), threading.Event()

        def _device(self, kind, batch):
            batch = np.asarray(batch)
            self.batches.append((kind, batch.shape))
            if len(self.batches) == 1:
                self.entered.set()
                assert self.gate.wait(timeout=30)
            return self._render(batch.reshape(batch.shape[0], -1))

        def device_images_from_vectors(self, batch):
            return self._device("z", batch)

        def device_images_from_matrices(self, batch):
            return self._device("w+", batch)

    return Gated()


def rows(seed: int, *shape: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def outcome(future, timeout: float = 30.0):
    """A future's result (as a list), or its error's type and message."""
    try:
        return ("ok", future.result(timeout=timeout).tolist())
    except Exception as error:  # pylint: disable=broad-except
        return ("error", type(error).__name__, str(error))


def scenario_coalesce(pkg, record):
    batcher_mod, runtime = PACKAGES[pkg]
    fake = gated_fake(runtime)
    with batcher_mod.DynamicBatcher(fake, max_batch=8, max_delay_ms=0) as batcher:
        first = batcher.submit(rows(0, 2, VECTOR))
        assert fake.entered.wait(timeout=30)
        queued = [batcher.submit(rows(1, 3, VECTOR)), batcher.submit(rows(2, 4, VECTOR)),
                  batcher.submit(rows(3, 2, 4, VECTOR)), batcher.submit(rows(4, 1, VECTOR)),
                  batcher.submit(rows(5, 2, 6, VECTOR))]
        fake.gate.set()
        record["results"] = [outcome(f) for f in [first] + queued]
        record["stats"] = {k: v for k, v in batcher.stats().items() if "latency" not in k}
    record["batches"] = fake.batches


def scenario_partial_consume(pkg, record):
    batcher_mod, runtime = PACKAGES[pkg]
    fake = gated_fake(runtime)
    fake.gate.set()
    data = rows(6, 20, VECTOR)
    with batcher_mod.DynamicBatcher(fake, max_batch=8, max_delay_ms=0) as batcher:
        record["results"] = [outcome(batcher.submit(data))]
        record["direct"] = fake._render(data).tolist()
        record["stats"] = {k: v for k, v in batcher.stats().items() if "latency" not in k}
    record["batches"] = fake.batches


def scenario_cancel(pkg, record):
    """A request cancelled while queued never reaches the device; one
    cancelled while its batch is in the device call is dropped on fetch."""
    batcher_mod, runtime = PACKAGES[pkg]
    fake = gated_fake(runtime)
    with batcher_mod.DynamicBatcher(fake, max_batch=8, max_delay_ms=0) as batcher:
        in_flight = batcher.submit(rows(7, 2, VECTOR))
        assert fake.entered.wait(timeout=30)
        queued = batcher.submit(rows(8, 3, VECTOR))
        record["cancelled"] = [in_flight.cancel(), queued.cancel()]
        kept = batcher.submit(rows(9, 1, VECTOR))
        fake.gate.set()
        record["kept"] = outcome(kept)
        record["idle"] = batcher.wait_idle(timeout_s=10)
        record["live"] = batcher.live_requests()
    record["batches"] = fake.batches


def scenario_retire(pkg, record):
    batcher_mod, runtime = PACKAGES[pkg]
    first, second = gated_fake(runtime), gated_fake(runtime)
    first.gate.set()
    with batcher_mod.DynamicBatcher([first, second], max_batch=8, max_delay_ms=0) as batcher:
        record["other"] = outcome(batcher.submit(rows(10, 2, VECTOR), network_index=0))
        busy = batcher.submit(rows(11, 2, VECTOR), network_index=1)
        assert second.entered.wait(timeout=30)
        record["timed_out"] = batcher.retire_network(1, timeout_s=0.2)
        second.gate.set()
        record["busy"] = outcome(busy)
        record["retired"] = batcher.retire_network(1, timeout_s=10)
        record["slot"] = batcher.networks[1] is None
        for call in (lambda: batcher.submit(rows(12, 1, VECTOR), network_index=1),
                     lambda: batcher.retire_network(0)):
            with pytest.raises(ValueError) as info:
                call()
            record.setdefault("errors", []).append(str(info.value))
        record["added"] = batcher.add_network(gated_fake(runtime))
        record["stats"] = {k: v for k, v in batcher.stats().items() if "latency" not in k}


def scenario_close(pkg, record):
    batcher_mod, runtime = PACKAGES[pkg]
    fake = gated_fake(runtime)
    batcher = batcher_mod.DynamicBatcher(fake, max_batch=8, max_delay_ms=0)
    in_flight = batcher.submit(rows(13, 2, VECTOR))
    assert fake.entered.wait(timeout=30)
    queued = batcher.submit(rows(14, 2, VECTOR))
    closer = threading.Thread(target=batcher.close)
    closer.start()
    time.sleep(0.2)
    fake.gate.set()
    closer.join(timeout=60)
    record["results"] = [outcome(in_flight), outcome(queued)]
    with pytest.raises(RuntimeError) as info:
        batcher.submit(rows(15, 1, VECTOR))
    record["submit_after_close"] = str(info.value)
    record["live"] = batcher.live_requests()
    record["batches"] = fake.batches


def scenario_bad_shapes(pkg, record):
    batcher_mod, runtime = PACKAGES[pkg]
    fake = gated_fake(runtime)
    fake.gate.set()
    with batcher_mod.DynamicBatcher(fake, max_batch=8) as batcher:
        for bad in (np.zeros((2, VECTOR + 1)), np.zeros((0, VECTOR)), np.zeros((2, 2, 2, 2)),
                    np.zeros((1, VECTOR))):
            index = 3 if bad.shape == (1, VECTOR) else 0
            with pytest.raises(ValueError) as info:
                batcher.submit(bad, network_index=index)
            record.setdefault("errors", []).append(str(info.value))


SCENARIOS = {
    "coalesce": scenario_coalesce, "partial_consume": scenario_partial_consume,
    "cancel": scenario_cancel, "retire": scenario_retire, "close": scenario_close,
    "bad_shapes": scenario_bad_shapes,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_batcher_behaves_as_jax(name):
    records = {}
    for pkg in PACKAGES:
        records[pkg] = {}
        SCENARIOS[name](pkg, records[pkg])
    assert records["port"] == records["jax"]
    if name == "coalesce":
        # the two z requests queued behind the gate share one bucket of 8; the
        # w+ rows (4 and 6 wide) and the last z request each take their own
        assert records["port"]["batches"][:2] == [("z", (8, VECTOR)), ("z", (8, VECTOR))]
        assert records["port"]["stats"]["batches"] == 5
    if name == "partial_consume":
        assert records["port"]["results"][0] == ("ok", records["port"]["direct"])


def test_batcher_over_a_real_network_matches_direct_synthesis():
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig, init_generator_params

    config = GeneratorConfig(resolution=16, fmap_base=256, fmap_max=32, latent_size=VECTOR,
                             dlatent_size=VECTOR, mapping_layers=2, mapping_fmaps=VECTOR)
    network = port_rt.SynthesisNetwork(params=init_generator_params(0, config), config=config,
                                       device="cpu")
    z, w = rows(20, 5, VECTOR), rows(21, 3, config.num_style_rows, VECTOR)
    with port_batcher.DynamicBatcher(network, max_batch=8, max_delay_ms=2) as batcher:
        futures = [batcher.submit(z), batcher.submit(w)]
        got_z, got_w = (f.result(timeout=60) for f in futures)
    np.testing.assert_array_equal(got_z, network.images_from_vectors(np.concatenate(
        [z, np.zeros((3, VECTOR), np.float32)]))[:5])
    np.testing.assert_array_equal(got_w, network.images_from_matrices(np.concatenate(
        [w, np.zeros((5,) + w.shape[1:], np.float32)]))[:3])
    # the entry points take a tensor as the batcher stages it for a CUDA network
    np.testing.assert_array_equal(
        network.device_images_from_vectors(torch.from_numpy(z)).numpy(),
        network.images_from_vectors(z))


def test_cuda_staging_is_only_for_cuda_networks():
    fake = port_rt.FakeSynthesisNetwork(resolution=8, expected_vector_length=VECTOR)
    data = rows(22, 2, VECTOR)
    staged, pinned = port_batcher._stage_rows(fake, data)
    assert staged is data and pinned is None
    images, ready = port_batcher._start_fetch(torch.zeros(4, 2, 2, 3, dtype=torch.uint8), 3)
    assert ready is None and port_batcher._host_frames(images, ready, 3).shape == (3, 2, 2, 3)


def test_serve_cli_help_usage_and_multi_device_refusals(monkeypatch):
    """The multi-device options, refused until they were ported, resolve as
    JAX's serve CLI resolves them: --use-mesh and --data-parallel build the
    serving mesh (a 'model' axis of the rest), --data-parallel with
    --no-mesh and a partial --dist-* triple are usage errors, and
    --control-port alone is ignored (it only matters with --dist-*)."""
    from click.testing import CliRunner

    from gance_tpu_torch.cli.serve import (
        ServeUsageError,
        build_cli,
        resolve_serving_mesh,
        run_server,
    )
    from tests.torch_parallel_worker import cpu_slots

    cli = build_cli()
    result = CliRunner().invoke(cli, ["--help"])
    assert result.exit_code == 0
    for option in ("--max-batch", "--max-delay-ms", "--warmup", "--warmup-audio", "--device",
                   "--compute-dtype", "--dist-coordinator", "--use-mesh", "--data-parallel",
                   "--control-port", "--control-bind"):
        assert option in result.output
    result = CliRunner().invoke(cli, [])
    assert result.exit_code == 2 and "No networks given" in result.output
    assert resolve_serving_mesh(None, None, "cpu") is None  # one device: no mesh
    assert resolve_serving_mesh(True, None, "cpu").shape == {"data": 1, "model": 1}
    cpu_slots(4, monkeypatch)
    assert resolve_serving_mesh(None, None, "cpu").shape == {"data": 4, "model": 1}
    assert resolve_serving_mesh(None, 2, "cpu").shape == {"data": 2, "model": 2}
    with pytest.raises(ServeUsageError, match="requires the mesh"):
        resolve_serving_mesh(False, 2, "cpu")
    with pytest.raises(ServeUsageError, match="must be given together"):
        run_server([Path("x.pkl")], device="cpu", dist_coordinator="h:1")
    with pytest.raises(FileNotFoundError):  # past the options, to the missing pickle
        run_server([Path("x.pkl")], device="cpu", control_port=9, use_mesh=False)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without CUDA")
def test_serve_cli_refuses_cuda_without_cuda():
    from gance_tpu_torch.cli.serve import run_server

    with pytest.raises(RuntimeError, match="is_available"):
        run_server([Path("x.pkl")], device="cuda")


def test_time_torch_serving_smoke_at_16px():
    """tools/time_torch_serving.py end to end on the CPU: one JSON line."""
    result = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "time_torch_serving.py"), "--device", "cpu",
         "--resolution", "16", "--fmap-base", "256", "--fmap-max", "32", "--seconds", "1",
         "--settle-seconds", "0.5", "--clients", "3", "--request-frames", "3",
         "--max-batch", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    line = json.loads(result.stdout.strip().splitlines()[-1])
    assert line["unit"] == "frames/sec" and line["value"] > 0
    assert line["batches"] > 0 and 0 < line["occupancy"] <= 1
    assert line["latency_p50_ms"] is not None and line["client_errors"] == 0
    assert line["device_idle_share"] is None  # --trace only
