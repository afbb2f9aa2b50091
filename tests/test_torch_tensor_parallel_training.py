"""
The port's tensor-parallel training (parallel/training.py over a mesh whose
'model' axis is 2) against gance_tpu's GSPMD training on the conftest's 8
virtual CPU devices: the counterpart of tests/test_distributed.py's
two-process run, with its 'model' axis.

  * two gloo processes x four CPU slots, data 4 x model 2 (each process two
    data rows of one model group each; the model axis inside the process),
    3 steps with r1_interval = 2 and pl_interval = 2, against JAX's
    single-process `make_train_step(mesh=create_mesh(data_parallel=4))` on
    the same global batches, with the sharding threshold lowered in both
    packages so that every 3x3 conv, D's Skip and Dense0 are split, and
    the gradients summed over the processes in many small buckets: the
    losses within 1e-4 relative at every step, every G, D and EMA leaf and
    `pl_mean` within the bounds of tests/test_torch_training.py's one-step
    test taken once per step (as tests/test_torch_parallel_training.py
    holds the data-parallel run), the replicated leaves one tensor on every
    slot and the two ranks' states equal bit for bit;
  * the checkpoint holds whole leaves: one written over a model-2 mesh loads
    on one device, one written on one device shards onto a model-2 mesh, and
    a step from either gives the same state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from gance_tpu.parallel import training as jax_training  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import (  # noqa: E402
    discriminator_params_from_reference,
    params_from_reference,
    training_state_from_reference,
)
from gance_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from gance_tpu_torch.parallel import training as port_training  # noqa: E402
from tests.test_torch_training import PARAM_ATOL, PARAM_RTOL, draws_from_jax_key  # noqa: E402
from tests.torch_parallel_worker import run_workers  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
          mapping_layers=2, mapping_fmaps=16)  # tests/test_distributed.py's MODEL
JAX_CONFIG, PORT_CONFIG = jax_g.GeneratorConfig(**KW), port_g.GeneratorConfig(**KW)
TRAIN = dict(r1_interval=2, pl_interval=2)
STEPS, BATCH = 3, 4
MIN_SHARDED = 1024  # every 3x3 conv, D's Skip and Dense0; the mapping and ToRGB whole
# the gradients' all-reduce in buckets of 16 KiB: a block of a 32-channel 3x3
# conv alone, runs of small leaves together (the default takes them all at once)
REDUCE_BUCKET_BYTES = 1 << 14


@pytest.fixture(scope="module")
def tp_trained(tmp_path_factory):
    """JAX's data 4 x model 2 run and the port's two-process run of the same
    3 steps from the same state."""
    tc = jax_training.TrainingConfig(**TRAIN)
    state = jax_training.init_training_state(jax.random.PRNGKey(0), JAX_CONFIG, tc)
    rng = np.random.RandomState(7)
    g_params = jax.tree_util.tree_map(  # non-zero biases, so that their sliced gradients count
        lambda v: v + jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32) if v.ndim <= 1 else v,
        state.g_params)
    g_params = {**g_params, "dlatent_avg": jnp.zeros_like(g_params["dlatent_avg"])}
    # EMA a copy, not the same arrays: the jitted step donates the state
    state = state._replace(g_params=g_params, ema_params=jax.tree_util.tree_map(jnp.copy, g_params))
    before = jax.tree_util.tree_map(np.asarray, state)
    reals = [rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32) for _ in range(STEPS)]
    keys = [jax.random.PRNGKey(100 + s) for s in range(STEPS)]

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_mesh, "_MIN_SHARDED_PARAM", MIN_SHARDED)
        mesh = jax_mesh.create_mesh(data_parallel=4)
        assert mesh.shape == {"data": 4, "model": 2}
        step = jax_training.make_train_step(JAX_CONFIG, tc, mesh=mesh)
        jax_state = jax_training.shard_training_state(mesh, state, tc)
        weight = jax_state.g_params["synthesis"]["8x8"]["Conv1"]["weight"]
        assert tuple(weight.sharding.spec) == (None, None, None, "model")
        jax_metrics = []
        for batch, key in zip(reals, keys):
            jax_state, m = step(jax_state, jnp.asarray(batch), key)
            jax_metrics.append({k: float(v) for k, v in m.items()})
        after = jax.tree_util.tree_map(np.asarray, jax_state)

    start = training_state_from_reference(before, port_training.TrainingConfig(**TRAIN), "cpu")
    tree = port_training.tree_to_numpy
    d = tmp_path_factory.mktemp("tp_train")
    inputs = dict(config=KW, train_config=TRAIN, reals=reals, data_parallel=4,
                  min_sharded=MIN_SHARDED, reduce_bucket_bytes=REDUCE_BUCKET_BYTES,
                  draws=[draws_from_jax_key(key, BATCH) for key in keys],
                  state=(tree(start.g_params), tree(start.d_params), tree(start.ema_params)))
    outs = run_workers("train", inputs, d, world=2, cpu_devices=4)
    return dict(after=after, metrics=jax_metrics, outs=outs, dir=d)


def test_tp_two_process_losses_match_jax_mesh(tp_trained):
    for out in tp_trained["outs"]:
        assert out["mesh"] == {"data": 4, "model": 2}
    for step, want in enumerate(tp_trained["metrics"]):
        for out in tp_trained["outs"]:
            got = out["metrics"][step]
            for name in ("d_loss", "g_loss", "r1", "pl"):
                assert abs(got[name] - want[name]) <= 1e-4 * abs(want[name]) + 1e-7, (step, name)
    assert [m["r1"] != 0.0 for m in tp_trained["metrics"]] == [True, False, True]
    assert [m["pl"] != 0.0 for m in tp_trained["metrics"]] == [True, False, True]


@pytest.mark.parametrize("which", ["g", "d", "ema"])
def test_tp_two_process_state_matches_jax_mesh(tp_trained, which):
    """tests/test_torch_parallel_training.py's bounds: each leaf within 1e-5
    plus 2 fp32 ulps of the value per step, and its Adam caveat for elements
    whose gradient is within fp32 noise of 0 (under 1% of a leaf per step);
    the two ranks equal bit for bit."""
    outs = tp_trained["outs"]
    convert = discriminator_params_from_reference if which == "d" else params_from_reference
    field = {"g": "g_params", "d": "d_params", "ema": "ema_params"}[which]
    want = dict(port_training.tree_leaves(convert(getattr(tp_trained["after"], field))))
    lr = port_training.TrainingConfig().learning_rate
    moves = 2.0 * lr * (STEPS if which != "ema" else 1e-3 * STEPS * (STEPS + 1) / 2)
    for path, got in port_training.tree_leaves(outs[0][which]):
        np.testing.assert_array_equal(got, dict(port_training.tree_leaves(outs[1][which]))[path])
        diff = np.abs(got - want[path])
        limit = PARAM_ATOL + STEPS * PARAM_RTOL * np.abs(want[path])
        assert float(np.mean(diff > limit)) < 0.01 * STEPS, path
        assert bool(np.all(diff <= limit + moves)), path


def test_tp_replicated_leaves_one_tensor_and_checkpoint_whole(tp_trained):
    """Every replicated leaf (mod_weight, biases, noise strengths, the
    mapping) is one tensor that every slot's tree names, in G, D and the EMA;
    process 0's checkpoint holds whole leaves that load on one device and
    equal the gathered state."""
    for out in tp_trained["outs"]:
        assert out["shared"] and all(out["shared"])
        assert out["step"] == STEPS and abs(out["pl_mean"] - float(tp_trained["after"].pl_mean)) <= 1e-5
    state = port_training.load_checkpoint(tp_trained["dir"] / "ckpt_0.pkl",
                                          port_training.TrainingConfig(**TRAIN), "cpu")
    assert isinstance(state.g_params, dict) and state.step == STEPS
    for path, leaf in port_training.tree_leaves(port_training.tree_to_numpy(state.g_params)):
        np.testing.assert_array_equal(leaf, dict(port_training.tree_leaves(
            tp_trained["outs"][0]["g"]))[path], err_msg=path)


def test_tp_checkpoint_loads_on_one_device_and_back(tmp_path, monkeypatch):
    """A checkpoint written over a model-2 mesh loads on one device, and one
    written on one device shards onto a model-2 mesh; a further step from
    each gives the same state (within 1e-4 of each leaf's size; the two run
    the same arithmetic on differently shaped convs)."""
    monkeypatch.setattr(port_mesh, "_MIN_SHARDED_PARAM", MIN_SHARDED)
    tc = port_training.TrainingConfig(**TRAIN)
    mesh = port_mesh.create_mesh(devices=["cpu"] * 2, data_parallel=1)
    reals = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (BATCH, 16, 16, 3)).astype(np.float32))
    draws = [port_training.draw_step(5, s, BATCH, PORT_CONFIG, tc, "cpu") for s in range(2)]
    tp = port_training.shard_training_state(
        mesh, port_training.init_training_state(6, PORT_CONFIG, tc, "cpu"), tc)
    tp, _ = port_training.make_train_step(PORT_CONFIG, tc, mesh)(tp, reals, draws[0])
    port_training.save_checkpoint(tmp_path / "tp.pkl", tp)
    one = port_training.load_checkpoint(tmp_path / "tp.pkl", tc, "cpu")
    assert one.step == 1 and isinstance(one.g_params, dict)
    port_training.save_checkpoint(tmp_path / "one.pkl", one)
    back = port_training.shard_training_state(
        mesh, port_training.load_checkpoint(tmp_path / "one.pkl", tc, "cpu"), tc)
    assert not isinstance(back.g_params, dict)
    for a, b in ((tp, one), (back, one)):
        for which in ("g_params", "d_params", "ema_params"):
            for path, leaf in port_training.tree_leaves(port_training.tree_to_numpy(
                    getattr(a, which))):
                np.testing.assert_array_equal(leaf, dict(port_training.tree_leaves(
                    port_training.tree_to_numpy(getattr(b, which))))[path], err_msg=path)
        moments = port_training._adam_to_numpy(a.g_opt_state, a.g_params)
        want = port_training._adam_to_numpy(one.g_opt_state, one.g_params)
        assert moments["count"] == want["count"] == 1
        for path, leaf in port_training.tree_leaves(moments["nu"]):
            np.testing.assert_array_equal(leaf, dict(port_training.tree_leaves(want["nu"]))[path])
    back, _ = port_training.make_train_step(PORT_CONFIG, tc, mesh)(back, reals, draws[1])
    one, _ = port_training.make_train_step(PORT_CONFIG, tc)(one, reals, draws[1])
    for path, want in port_training.tree_leaves(port_training.tree_to_numpy(one.g_params)):
        got = dict(port_training.tree_leaves(port_training.tree_to_numpy(back.g_params)))[path]
        assert float(np.abs(got - want).max()) <= 1e-4 * max(float(np.abs(want).max()), 1.0), path
