"""
The port's data-parallel training (gance_tpu_torch.parallel.training with a
mesh, `minibatch_stddev` across ranks, the train CLI's --dist-*) against
gance_tpu's multi-device training on the conftest's virtual CPU devices.

  * minibatch stddev of a batch split over two gloo processes (global batch
    8 and 4, group 4: the groups are strided, so a group spans both ranks):
    values and input gradients equal JAX's `minibatch_stddev` of the whole
    batch within 1e-5 relative;
  * two gloo processes x two CPU slots, 3 steps with r1_interval = 2 and
    pl_interval = 2, against JAX's single-process `make_train_step(mesh=
    create_mesh(n_devices=4, data_parallel=4))` on the same global batches,
    each process handing in only its rows of the reals: the losses within
    1e-4 relative at every step; every G, D and EMA leaf and `pl_mean` within
    the bounds of tests/test_torch_training.py's one-step test, taken once
    per step (its rounding bound and its Adam caveat for elements whose
    gradient is within fp32 noise of 0); the two ranks' states equal bit for
    bit; only process 0 writes the checkpoint;
  * the train CLI as two --dist-* processes on the CPU: per-process dataset
    shards, the scanned path, one checkpoint and one exported network;
    --metrics-every with --dist-* is JAX's usage error.
"""

import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from gance_tpu.parallel import training as jax_training  # noqa: E402
from gance_tpu_torch.models.convert import (  # noqa: E402
    discriminator_params_from_reference,
    params_from_reference,
    training_state_from_reference,
)
from gance_tpu_torch.parallel import training as port_training  # noqa: E402
from tests.test_torch_training import PARAM_ATOL, PARAM_RTOL, draws_from_jax_key  # noqa: E402
from tests.torch_parallel_worker import free_port, launch, run_workers  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
          mapping_layers=2, mapping_fmaps=16)  # tests/test_distributed.py's MODEL
JAX_CONFIG = jax_g.GeneratorConfig(**KW)
TRAIN = dict(r1_interval=2, pl_interval=2)
STEPS, BATCH = 3, 4


@pytest.mark.parametrize("batch", [8, 4])
def test_minibatch_stddev_across_two_processes_matches_jax(tmp_path, batch):
    rng = np.random.RandomState(batch)
    x = rng.randn(batch, 6, 4, 4).astype(np.float32)
    weights = rng.randn(batch, 7, 4, 4).astype(np.float32)

    def jax_fn(x_nhwc):
        out = jax_g.minibatch_stddev(x_nhwc, 4, 1)
        return out, jnp.sum(out * jnp.asarray(weights.transpose(0, 2, 3, 1)))

    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(jax_fn(x_nhwc)[0]).transpose(0, 3, 1, 2)
    want_grad = np.asarray(jax.grad(lambda v: jax_fn(v)[1])(x_nhwc)).transpose(0, 3, 1, 2)
    outs = run_workers("mbstd", dict(x=x, weights=weights, group=4), tmp_path)
    got = np.concatenate([o["values"] for o in outs])
    got_grad = np.concatenate([o["grads"] for o in outs])
    for a, b in ((got, want), (got_grad, want_grad)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX's 4-device mesh run and the port's two-process run of the same
    3 steps from the same state."""
    tc = jax_training.TrainingConfig(**TRAIN)
    state = jax_training.init_training_state(jax.random.PRNGKey(0), JAX_CONFIG, tc)
    rng = np.random.RandomState(7)
    g_params = jax.tree_util.tree_map(  # non-zero biases, so their gradients count
        lambda v: v + jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32) if v.ndim <= 1 else v,
        state.g_params)
    g_params = {**g_params, "dlatent_avg": jnp.zeros_like(g_params["dlatent_avg"])}
    # EMA a copy, not the same arrays: the jitted step donates the state
    state = state._replace(g_params=g_params, ema_params=jax.tree_util.tree_map(jnp.copy, g_params))
    before = jax.tree_util.tree_map(np.asarray, state)
    reals = [rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32) for _ in range(STEPS)]
    keys = [jax.random.PRNGKey(100 + s) for s in range(STEPS)]

    mesh = jax_mesh.create_mesh(n_devices=4, data_parallel=4)
    step = jax_training.make_train_step(JAX_CONFIG, tc, mesh=mesh)
    jax_state = jax_training.shard_training_state(mesh, state, tc)
    jax_metrics = []
    for batch, key in zip(reals, keys):
        jax_state, m = step(jax_state, jnp.asarray(batch), key)
        jax_metrics.append({k: float(v) for k, v in m.items()})
    after = jax.tree_util.tree_map(np.asarray, jax_state)

    start = training_state_from_reference(before, port_training.TrainingConfig(**TRAIN), "cpu")
    tree = port_training.tree_to_numpy
    d = tmp_path_factory.mktemp("train")
    inputs = dict(config=KW, train_config=TRAIN, reals=reals,
                  draws=[draws_from_jax_key(key, BATCH) for key in keys],
                  state=(tree(start.g_params), tree(start.d_params), tree(start.ema_params)))
    outs = run_workers("train", inputs, d, world=2, cpu_devices=2)
    return dict(before=before, after=after, metrics=jax_metrics, outs=outs, dir=d)


def test_two_process_losses_match_jax_mesh(trained):
    for step, want in enumerate(trained["metrics"]):
        for out in trained["outs"]:
            got = out["metrics"][step]
            for name in ("d_loss", "g_loss", "r1", "pl"):
                assert abs(got[name] - want[name]) <= 1e-4 * abs(want[name]) + 1e-7, (step, name)
    assert [m["r1"] != 0.0 for m in trained["metrics"]] == [True, False, True]
    assert [m["pl"] != 0.0 for m in trained["metrics"]] == [True, False, True]


@pytest.mark.parametrize("which", ["g", "d", "ema"])
def test_two_process_state_matches_jax_mesh(trained, which):
    """The one-step test's bounds, taken once per step: each leaf within 1e-5
    plus 2 fp32 ulps of the value per step (XLA fuses the EMA's multiply-add
    where PyTorch rounds twice, once a step); and its Adam caveat: with b1 =
    0 an element whose gradient is within fp32 noise of 0 may move by up to
    2 lr a step (1e-3 of that in the EMA) on a difference far below that
    noise; such elements, under 1% of a leaf per step, are held to that."""
    outs = trained["outs"]
    convert = discriminator_params_from_reference if which == "d" else params_from_reference
    field = {"g": "g_params", "d": "d_params", "ema": "ema_params"}[which]
    want = dict(port_training.tree_leaves(convert(getattr(trained["after"], field))))
    lr = port_training.TrainingConfig().learning_rate
    moves = 2.0 * lr * (STEPS if which != "ema" else 1e-3 * STEPS * (STEPS + 1) / 2)
    for path, got in port_training.tree_leaves(outs[0][which]):
        np.testing.assert_array_equal(got, dict(port_training.tree_leaves(outs[1][which]))[path])
        diff = np.abs(got - want[path])
        limit = PARAM_ATOL + STEPS * PARAM_RTOL * np.abs(want[path])
        assert float(np.mean(diff > limit)) < 0.01 * STEPS, path
        assert bool(np.all(diff <= limit + moves)), path


def test_two_process_pl_mean_step_and_checkpoint(trained):
    for out in trained["outs"]:
        assert out["step"] == int(trained["after"].step) == STEPS
        assert abs(out["pl_mean"] - float(trained["after"].pl_mean)) <= 1e-5
        assert out["g_adam"]["count"] == STEPS
    assert (trained["dir"] / "ckpt_0.pkl").exists()
    assert not (trained["dir"] / "ckpt_1.pkl").exists()  # only process 0 writes
    with open(trained["dir"] / "ckpt_0.pkl", "rb") as f:
        assert pickle.load(f)["step"] == STEPS


def _train_cli(dataset, checkpoint, network, port, rank, extra=()):
    return [sys.executable, "-m", "gance_tpu_torch.cli.train", "--dataset-directory",
            str(dataset), "--resolution", "16", "--batch-size", "2", "--total-steps", "2",
            "--checkpoint-every", "2", "--scan-segment", "2", "--fmap-base", "256",
            "--fmap-max", "32", "--latent-size", "16", "--pl-weight", "0", "--device", "cpu",
            "--checkpoint-path", str(checkpoint), "--output-network", str(network),
            "--dist-coordinator", f"localhost:{port}", "--dist-num-processes", "2",
            "--dist-process-id", str(rank), *extra]


def test_train_cli_multiprocess_smoke(tmp_path):
    """The port's train CLI as two --dist-* processes (JAX's
    tests/test_distributed.py::test_train_cli_multiprocess_smoke): process 0
    writes the checkpoint and the network, which loads in both packages."""
    from PIL import Image

    from gance_tpu.models.pickle_loader import load_generator

    dataset = tmp_path / "dataset"
    dataset.mkdir()
    rng = np.random.RandomState(7)
    for index in range(8):
        Image.fromarray(rng.randint(0, 255, size=(16, 16, 3), dtype=np.uint8)).save(
            dataset / f"img_{index}.png")
    checkpoint, network = tmp_path / "ckpt.pkl", tmp_path / "trained.pkl"
    port = free_port()
    results = launch([_train_cli(dataset, checkpoint, network, port, rank) for rank in range(2)],
                     timeout=300)
    for rank, (code, output) in enumerate(results):
        assert code == 0, f"rank {rank}: {output[-3000:]}"
    assert "over gloo" in results[0][1]
    with open(checkpoint, "rb") as f:
        assert pickle.load(f)["step"] == 2
    params, config = load_generator(network)
    assert config.resolution == 16
    from gance_tpu_torch.models.pickle_loader import load_generator as port_load

    assert port_load(network)[1].resolution == 16
    refused = launch([_train_cli(dataset, checkpoint, network, free_port(), 0,
                                 ["--metrics-every", "2"])], timeout=120)
    assert refused[0][0] == 2 and "single-process-only" in refused[0][1]


@pytest.mark.parametrize("host_count", [1, 2, 3])
def test_dataset_host_shards_match_jax(tmp_path, host_count):
    """`list_image_paths` and `StreamingImageDataset` shard the image folder
    round-robin by process as JAX's do (parallel/data.py)."""
    from PIL import Image

    from gance_tpu.parallel.data import StreamingImageDataset as JaxDataset
    from gance_tpu.parallel.data import list_image_paths as jax_paths
    from gance_tpu_torch.parallel.data import StreamingImageDataset, list_image_paths

    rng = np.random.RandomState(host_count)
    for index in range(7):
        Image.fromarray(rng.randint(0, 255, size=(8, 8, 3), dtype=np.uint8)).save(
            tmp_path / f"img_{index}.png")
    for host in range(host_count):
        assert list_image_paths(tmp_path, host, host_count) == jax_paths(tmp_path, host, host_count)
        ours = list(StreamingImageDataset(tmp_path, 8, seed=2, host_index=host,
                                          host_count=host_count).batches(0, 2, 2))
        theirs = list(JaxDataset(tmp_path, 8, seed=2, host_index=host,
                                 host_count=host_count).batches(0, 2, 2))
        for (s1, a), (s2, b) in zip(ours, theirs):
            assert s1 == s2
            np.testing.assert_array_equal(a, b)
