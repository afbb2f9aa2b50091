"""
The port's tensor-parallel 'model' axis (gance_tpu_torch.parallel:
mesh.py's sharding policy, the model's forwards over tensor_parallel.py's
column-parallel `GroupParams`, and `SynthesisNetwork` / `MultiNetwork` on a
mesh with model 2) against gance_tpu's GSPMD sharding on the conftest's 8
virtual CPU devices.

  * the sharding policy leaf for leaf against JAX's
    `generator_param_sharding(...).spec` and the discriminator's, at
    tests/test_parallel.py's `big` config (the real 64k threshold);
  * synthesis over data 4 x model 2 (z and w+) against JAX's
    `make_sharded_synthesis` / `make_sharded_matrix_synthesis` on
    `create_mesh(data_parallel=4)`: within 1 uint8 step, as JAX's own
    `test_sharded_synthesis_tensor_parallel` asserts; kernel A's twin runs
    once per slot per sharded noise layer;
  * the phase path with a sharded top `Conv0_up` against JAX's phase path,
    kernel E's twin once per data row;
  * the discriminator over model 2 against JAX's `discriminator_apply`;
  * `SynthesisNetwork` / `MultiNetwork` over a model-2 mesh pad to the data
    axis and give the single device's frames;
  * the 'model' axis stays inside a process.

The tiny configs hold no leaf of 64k elements, so the tests that need
sharding lower `_MIN_SHARDED_PARAM` in both packages to one value and assert
that leaves were sharded. Inputs come from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from gance_tpu.parallel.sharded_synthesis import (  # noqa: E402
    make_sharded_matrix_synthesis as jax_matrix_synthesis,
)
from gance_tpu.parallel.sharded_synthesis import (  # noqa: E402
    make_sharded_synthesis as jax_sharded_synthesis,
)
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import (  # noqa: E402
    discriminator_params_from_reference,
    params_from_reference,
)
from gance_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from gance_tpu_torch.parallel.sharded_synthesis import (  # noqa: E402
    make_sharded_matrix_synthesis,
    make_sharded_synthesis,
)
from gance_tpu_torch.parallel.tensor_parallel import GroupParams  # noqa: E402
from gance_tpu_torch.parallel.training import tree_leaves  # noqa: E402
from gance_tpu_torch.synthesis.runtime import MultiNetwork, SynthesisNetwork  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
          mapping_layers=2, mapping_fmaps=16)  # tests/test_parallel.py's TINY
JAX_CONFIG, PORT_CONFIG = jax_g.GeneratorConfig(**KW), port_g.GeneratorConfig(**KW)
# shards every 3x3 conv, the D's Skip and Dense0; keeps the mapping, ToRGB whole
MIN_SHARDED = 1024
# the phase path: a top block under 128 channels whose Conv0_up (64 -> 32,
# 18432 elements) is sharded and whose Conv1 (32 -> 32, 9216) is whole
PHASE_KW = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=16, dlatent_size=16,
                mapping_layers=2, mapping_fmaps=16)
PHASE_MIN_SHARDED = 16384


@pytest.fixture
def lowered(monkeypatch):
    """Lower the sharding threshold in both packages to one value."""
    def lower(value: int) -> None:
        monkeypatch.setattr(jax_mesh, "_MIN_SHARDED_PARAM", value)
        monkeypatch.setattr(port_mesh, "_MIN_SHARDED_PARAM", value)
    return lower


def jax_params(seed: int, config=JAX_CONFIG):
    params = jax_g.init_generator_params(jax.random.PRNGKey(seed), config)
    rng = np.random.RandomState(seed)
    # non-zero biases and noise strengths, so that the sliced ones count
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.2 * rng.randn(*np.shape(v))).astype(np.float32)
        if np.ndim(v) <= 1 else np.asarray(v), params)


def assert_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def count_sharded(group: GroupParams) -> int:
    return sum(dim is not None for _, dim in tree_leaves(group.spec))


def _twin_calls(monkeypatch, name: str):
    """Record the batch size of each call of a kernel's CPU twin."""
    from gance_tpu_torch.ops.cuda import fused_ops as K

    calls = []
    real = getattr(K, name)

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(K, name, counted)
    return calls


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_sharding_policy_matches_jax_leaf_for_leaf(which):
    """JAX's `big` config (tests/test_parallel.py) at the real threshold:
    every leaf is sharded exactly where JAX's spec says 'model', along the
    port's layout of JAX's last axis."""
    big = dict(resolution=32, fmap_base=8192, fmap_max=512, latent_size=512,
               dlatent_size=512, mapping_layers=2)
    jax_config, port_config = jax_g.GeneratorConfig(**big), port_g.GeneratorConfig(**big)
    key = jax.random.PRNGKey(0)
    mesh = jax_mesh.create_mesh(data_parallel=4)
    if which == "generator":
        shapes = jax.eval_shape(lambda: jax_g.init_generator_params(key, jax_config))
        specs = jax_mesh.generator_param_sharding(mesh, shapes)
        port = port_g.init_generator_params(0, port_config)
    else:
        shapes = jax.eval_shape(lambda: jax_g.init_discriminator_params(key, jax_config))
        specs = jax_mesh.discriminator_param_sharding(mesh, shapes)
        port = port_g.init_discriminator_params(0, port_config)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        want["/".join(k.key for k in path)] = tuple(sharding.spec)
    got = dict(tree_leaves(port_mesh.param_spec(port)))
    assert set(got) == set(want)
    sharded = 0
    for path, dim in got.items():
        shape = dict(tree_leaves(port))[path].shape
        if dim is None:
            assert want[path] == (), path
            continue
        sharded += 1
        jax_axes = (None,) * (len(shape) - 1) + ("model",)
        assert want[path] == jax_axes, path
        assert dim == (0 if len(shape) == 4 else len(shape) - 1), path
    assert sharded >= (8 if which == "generator" else 6)


@pytest.mark.parametrize("batch", [4, 5])
def test_tensor_parallel_synthesis_matches_jax(monkeypatch, lowered, batch):
    """data 4 x model 2, z and w+: within 1 uint8 step of JAX's GSPMD run on
    create_mesh(data_parallel=4) (JAX's own test_sharded_synthesis_tensor_
    parallel bound). Each non-empty data row runs kernel A's twin once per
    slot on its channel block of every noise layer (all are sharded here)."""
    lowered(MIN_SHARDED)
    params = jax_params(1)
    rng = np.random.RandomState(batch)
    z = rng.randn(batch, 16).astype(np.float32)
    w = rng.randn(batch, JAX_CONFIG.num_style_rows, 16).astype(np.float32)
    mesh_j = jax_mesh.create_mesh(data_parallel=4)
    assert mesh_j.shape == {"data": 4, "model": 2}
    want_z = np.asarray(jax_sharded_synthesis(mesh_j, params, JAX_CONFIG)(z))
    want_w = np.asarray(jax_matrix_synthesis(mesh_j, params, JAX_CONFIG)(w))
    mesh = port_mesh.create_mesh(devices=["cpu"] * 8, data_parallel=4)
    assert mesh.shape == {"data": 4, "model": 2}
    port_params = params_from_reference(params)
    calls = _twin_calls(monkeypatch, "_fused_bias_noise_lrelu_run")
    got_z = make_sharded_synthesis(mesh, port_params, PORT_CONFIG)(z)
    group = next(iter(port_mesh.generator_param_sharding(mesh, port_params).values()))
    assert count_sharded(group) == 5  # the 4x4 Conv and the two 3x3 convs per block
    rows = [s.stop - s.start for s in port_mesh.shard_slices(batch, 4) if s.stop > s.start]
    layers = PORT_CONFIG.num_style_rows - 1
    assert len(calls) == len(rows) * layers * 2
    assert sorted({c[1] for c in calls}) == [16]  # 32 channels, two blocks of 16
    got_w = make_sharded_matrix_synthesis(mesh, port_params, PORT_CONFIG)(w)
    assert_within_one_step(got_z, want_z)
    assert_within_one_step(got_w, want_w)


@pytest.mark.parametrize("uint8_output", [True, False])
def test_tensor_parallel_phase_path_matches_jax(monkeypatch, lowered, uint8_output):
    """The polyphase top block with its Conv0_up sharded (each slot folds its
    block; the phase planes are gathered within each phase) against JAX's
    phase path: within 1 uint8 step, and kernel E's twin runs once, whole,
    on the lead."""
    lowered(PHASE_MIN_SHARDED)
    jax_config, port_config = jax_g.GeneratorConfig(**PHASE_KW), port_g.GeneratorConfig(**PHASE_KW)
    params = jax_params(3, jax_config)
    w = np.random.RandomState(4).randn(3, jax_config.num_style_rows, 16).astype(np.float32)
    want = jax_g.synthesis_apply(params, jnp.asarray(w), jax_config, phase_top_block_mode=True,
                                 uint8_output=uint8_output)
    group = GroupParams.place(params_from_reference(params), ["cpu", "cpu"])
    top = group.spec["synthesis"]["32x32"]
    assert top["Conv0_up"]["weight"] == 0 and top["Conv1"]["weight"] is None
    e_calls = _twin_calls(monkeypatch, "_phase_conv1_torgb_run")
    with torch.inference_mode():
        got = port_g.synthesis_apply(group, torch.from_numpy(w), port_config,
                                     phase_top_block_mode=True, uint8_output=uint8_output)
    assert len(e_calls) == 1
    if not uint8_output:
        got, want = port_g.images_to_uint8(got), jax_g.images_to_uint8(want)
    assert_within_one_step(got.numpy(), np.asarray(want))


def test_tensor_parallel_discriminator_matches_jax(lowered):
    """D over model 2 (its 3x3 convs, Skip and Dense0 sharded; the down
    blurs once on the lead): the logits within 1e-4 relative of JAX's."""
    lowered(MIN_SHARDED)
    d = jax_g.init_discriminator_params(jax.random.PRNGKey(5), JAX_CONFIG)
    images = np.random.RandomState(6).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax_g.discriminator_apply(d, jnp.asarray(images), JAX_CONFIG))
    group = GroupParams.place(discriminator_params_from_reference(
        jax.tree_util.tree_map(np.asarray, d)), ["cpu", "cpu"])
    assert count_sharded(group) == 8  # two blocks of Conv0, Conv1_down, Skip; Conv; Dense0
    got = port_g.discriminator_apply(group, torch.from_numpy(images), PORT_CONFIG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_group_params_gather_and_layouts_round_trip(lowered):
    lowered(MIN_SHARDED)
    params = params_from_reference(jax_params(7))
    group = GroupParams.place(params, ["cpu"] * 3)  # 32 channels in blocks of 11, 11, 10
    block = group.slots[2]["synthesis"]["8x8"]["Conv1"]["weight"]
    assert tuple(block.shape) == (10, 32, 3, 3)
    for path, leaf in tree_leaves(port_mesh.gather_params(group)):
        np.testing.assert_array_equal(leaf, dict(tree_leaves(params))[path], err_msg=path)
    arrays = group.flat_arrays(params)
    assert [a.shape for a in arrays] == [tuple(t.shape) for t in group.flat()]
    for path, leaf in tree_leaves(group.whole(arrays)):
        np.testing.assert_array_equal(leaf, dict(tree_leaves(params))[path], err_msg=path)
    shared = GroupParams.place(params, ["cpu"] * 2, shared=True, trainable=True)
    assert shared.slots[0]["dlatent_avg"] is shared.slots[1]["dlatent_avg"]
    assert all(t.requires_grad for t in shared.flat())


def test_model_axis_stays_inside_a_process(monkeypatch):
    """Three slots per process in a group of two: data 2 x model 3 keeps
    each row in one process; data 3 x model 2 would split a row, which
    raises saying why."""
    monkeypatch.setattr(port_mesh, "process_group_info", lambda group=None: (0, 2))
    mesh = port_mesh.create_mesh(devices=["cpu"] * 3, data_parallel=2)
    assert mesh.shape == {"data": 2, "model": 3}
    assert port_mesh.local_row_groups(mesh) == [(torch.device("cpu"),) * 3]
    with pytest.raises(ValueError, match="stays inside one process"):
        port_mesh.create_mesh(devices=["cpu"] * 3, data_parallel=3)


def test_synthesis_network_and_multinetwork_on_a_model_axis(monkeypatch, lowered, tmp_path):
    """5 frames over data 2 x model 2: padded to 6, the pad sliced off, the
    single device's frames within 1 step (bit for bit here on the CPU); a
    MultiNetwork over the same mesh streams both networks' frames."""
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle

    lowered(MIN_SHARDED)
    params = [params_from_reference(jax_params(10 + i)) for i in range(2)]
    mesh = port_mesh.create_mesh(devices=["cpu"] * 4, data_parallel=2)
    z = np.random.RandomState(8).randn(5, 16).astype(np.float32)
    calls = _twin_calls(monkeypatch, "_fused_bias_noise_lrelu_run")
    network = SynthesisNetwork(params=params[0], config=PORT_CONFIG, mesh=mesh)
    assert isinstance(network.params, GroupParams)
    frames = network.images_from_vectors(z)
    assert frames.shape == (5, 16, 16, 3)
    assert [c[0] for c in calls] == [3] * (PORT_CONFIG.num_style_rows - 1) * 2 * 2
    singles = [SynthesisNetwork(params=p, config=PORT_CONFIG, device="cpu") for p in params]
    np.testing.assert_array_equal(frames, singles[0].images_from_vectors(z))
    paths = []
    for i, p in enumerate(params):
        paths.append(tmp_path / f"{i}_net.pkl")
        save_generator_pickle(p, paths[-1])
    indices = np.array([0, 1, 1, 0, 1, 0, 0])
    stream_z = np.random.RandomState(9).randn(7, 16).astype(np.float32)
    with MultiNetwork(paths, mesh=mesh, device="cpu") as multi:
        got = multi.synthesize_all(stream_z, indices, batch_size=4)
    for row, index in enumerate(indices):
        assert_within_one_step(got[row], singles[index].images_from_vectors(stream_z[row:row + 1])[0])
