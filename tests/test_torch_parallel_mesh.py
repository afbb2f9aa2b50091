"""
The port's meshes and data-parallel synthesis (gance_tpu_torch.parallel:
mesh.py, sharded_synthesis.py, distributed.py, `SynthesisNetwork(mesh=)`)
against gance_tpu's on the conftest's 8 virtual CPU devices.

  * mesh shapes and `_hybrid_device_grid` against JAX's, a 'model' axis
    larger than 1 included (tests/test_torch_tensor_parallel.py runs it);
  * `make_sharded_synthesis` / `make_sharded_matrix_synthesis` over a
    4-slot CPU mesh against JAX's over `create_mesh(n_devices=4)`, at batch
    sizes the data axis does not divide: within 1 uint8 step (the port's
    single-device bound); empty shards launch nothing;
  * `SynthesisNetwork(mesh=)` pads to the data axis and slices back;
  * two gloo processes with two CPU slots each: sharded, mesh and
    network-parallel synthesis equal the single-process frames exactly
    (every shard computes the same rows at the same batch size), the backend
    choice, and `initialize_distributed`'s idempotence and conflict error.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from gance_tpu.parallel.sharded_synthesis import (  # noqa: E402
    make_sharded_matrix_synthesis as jax_matrix_synthesis,
)
from gance_tpu.parallel.sharded_synthesis import (  # noqa: E402
    make_sharded_synthesis as jax_sharded_synthesis,
)
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.parallel import distributed  # noqa: E402
from gance_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from gance_tpu_torch.parallel.sharded_synthesis import (  # noqa: E402
    make_sharded_matrix_synthesis,
    make_sharded_synthesis,
)
from gance_tpu_torch.synthesis.runtime import SynthesisNetwork  # noqa: E402
from tests.torch_parallel_worker import cpu_slots as use_cpu_slots  # noqa: E402
from tests.torch_parallel_worker import run_workers  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
          mapping_layers=2, mapping_fmaps=16)  # tests/test_distributed.py's MODEL
JAX_CONFIG, PORT_CONFIG = jax_g.GeneratorConfig(**KW), port_g.GeneratorConfig(**KW)


def jax_params(seed: int):
    return jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(seed), JAX_CONFIG))


def assert_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


@pytest.fixture
def cpu_slots(monkeypatch):
    """Eight CPU slots for create_mesh(device='cpu'), as JAX has eight devices."""
    use_cpu_slots(8, monkeypatch)


@pytest.mark.parametrize("kwargs", [{}, dict(n_devices=4, data_parallel=4),
                                    dict(n_devices=8, data_parallel=4),
                                    dict(n_devices=8, data_parallel=3)])
def test_mesh_shapes_match_jax(cpu_slots, kwargs):
    """The same shapes as JAX's create_mesh, a tensor-parallel 'model' axis
    included (each data row's slots in row-major order, as JAX reshapes its
    devices); an indivisible dp is a ValueError in both."""
    try:
        want = jax_mesh.create_mesh(**kwargs)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            port_mesh.create_mesh(device="cpu", **kwargs)
        return
    got = port_mesh.create_mesh(device="cpu", **kwargs)
    assert port_mesh.model_axis_size(got) == want.shape["model"]
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape) and got.size == want.devices.size
    assert got.process_count == 1 and got.local_devices == [torch.device("cpu")]


def test_explicit_device_list_may_repeat_a_device():
    mesh = port_mesh.create_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 3, "model": 1}
    assert [s.device for s in mesh.devices.flat] == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="no devices"):
        port_mesh.create_mesh(devices=[])


def test_hybrid_device_grid_matches_jax():
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class StubDevice:
        id: int
        slice_index: int

    devices = [StubDevice(id=s * 4 + i, slice_index=s) for s in range(2) for i in range(4)]
    for dp, mp in [(4, 2), (8, 1), (2, 4)]:
        want = jax_mesh._hybrid_device_grid(devices, dp, mp)
        got = port_mesh._hybrid_device_grid(devices, dp, mp)
        assert [[d.id for d in row] for row in got] == [[d.id for d in row] for row in want]
    for args, match in [((devices, 1, 8), "ICI"), ((devices[:7], 7, 1), "Uneven"),
                        ((devices, 3, 2), "dp=3")]:
        with pytest.raises(ValueError, match=match):
            jax_mesh._hybrid_device_grid(*args)
        with pytest.raises(ValueError, match=match):
            port_mesh._hybrid_device_grid(*args)


def test_param_sharding_replicates_and_refuses_a_model_axis(monkeypatch):
    """A 'model' axis of 1 copies the params once per device (keyed by the
    data row's devices); a 'model' axis of 2, no longer refused, places a
    tensor-parallel GroupParams per data row whose large weights are split
    over the slots and gather back whole."""
    from gance_tpu_torch.parallel.tensor_parallel import GroupParams

    params = params_from_reference(jax_params(0))
    mesh = port_mesh.create_mesh(devices=["cpu", "cpu"])
    placed = port_mesh.generator_param_sharding(mesh, params)
    assert list(placed) == [(torch.device("cpu"),)]
    np.testing.assert_array_equal(placed[(torch.device("cpu"),)]["synthesis"]["4x4"]["Conv"]
                                  ["weight"].numpy(), params["synthesis"]["4x4"]["Conv"]["weight"])
    monkeypatch.setattr(port_mesh, "_MIN_SHARDED_PARAM", 1024)
    model = port_mesh.Mesh(port_mesh._object_grid([port_mesh.MeshDevice(0, torch.device("cpu"))]
                                                  * 2, (1, 2)), ("data", "model"))
    d_params = port_g.init_discriminator_params(0, PORT_CONFIG)
    for fn, tree in ((port_mesh.generator_param_sharding, params),
                     (port_mesh.discriminator_param_sharding, d_params)):
        (group,) = fn(model, tree).values()
        assert isinstance(group, GroupParams) and len(group.slots) == 2
        assert any(dim is not None for _, dim in _leaves(group.spec))
        for path, leaf in _leaves(port_mesh.gather_params(group)):
            np.testing.assert_array_equal(leaf, dict(_leaves(tree))[path], err_msg=path)


def _leaves(tree, prefix=""):
    from gance_tpu_torch.parallel.training import tree_leaves

    return tree_leaves(tree, prefix)


@pytest.mark.parametrize("n,parts,want", [
    (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)]), (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]),
    (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]), (0, 2, [(0, 0), (0, 0)]),
])
def test_shard_slices_are_xla_blocks(n, parts, want):
    """ceil(n / parts) rows a slot, the last short or empty, as XLA pads an
    uneven batch."""
    assert [(s.start, s.stop) for s in port_mesh.shard_slices(n, parts)] == want


def _counted(monkeypatch):
    """Count the plain twins' calls per batch size (the kernels' CPU route)."""
    from gance_tpu_torch.ops.cuda import fused_ops as K

    calls = []
    real = K._fused_bias_noise_lrelu_run

    def counted(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(K, "_fused_bias_noise_lrelu_run", counted)
    return calls


@pytest.mark.parametrize("batch", [5, 3])
def test_sharded_synthesis_matches_jax(monkeypatch, batch):
    """z and w+ over 4 data slots, batch sizes 4 does not divide: within 1
    uint8 step of JAX's sharded synthesis on 4 devices. Shards are ceil(B/4)
    rows; the empty one launches nothing (kernel A's twin runs once per
    noise layer per non-empty shard)."""
    params = jax_params(1)
    rng = np.random.RandomState(batch)
    z = rng.randn(batch, 16).astype(np.float32)
    w = rng.randn(batch, JAX_CONFIG.num_style_rows, 16).astype(np.float32)
    jax_mesh_4 = jax_mesh.create_mesh(n_devices=4)
    want_z = np.asarray(jax_sharded_synthesis(jax_mesh_4, params, JAX_CONFIG)(z))
    want_w = np.asarray(jax_matrix_synthesis(jax_mesh_4, params, JAX_CONFIG)(w))
    mesh = port_mesh.create_mesh(devices=["cpu"] * 4)
    port_params = params_from_reference(params)
    calls = _counted(monkeypatch)
    got_z = make_sharded_synthesis(mesh, port_params, PORT_CONFIG)(z)
    shards = [s.stop - s.start for s in port_mesh.shard_slices(batch, 4) if s.stop > s.start]
    layers = PORT_CONFIG.num_style_rows - 1
    assert sorted(calls) == sorted(shards * layers)
    got_w = make_sharded_matrix_synthesis(mesh, port_params, PORT_CONFIG)(w)
    assert_within_one_step(got_z, want_z)
    assert_within_one_step(got_w, want_w)


def test_synthesis_network_on_a_mesh_pads_to_the_data_axis(monkeypatch):
    """5 frames over 2 slots: padded to 6 (the last row twice), two shards of
    3, the pad sliced off; the frames are the single device's within 1 step
    and equal the JAX mesh network's within 1 step."""
    params = jax_params(2)
    z = np.random.RandomState(4).randn(5, 16).astype(np.float32)
    mesh = port_mesh.create_mesh(devices=["cpu", "cpu"])
    calls = _counted(monkeypatch)
    network = SynthesisNetwork(params=params_from_reference(params), config=PORT_CONFIG, mesh=mesh)
    frames = network.device_images_from_vectors(z)
    assert isinstance(frames, port_mesh.ShardedRows) and frames.shape == (5, 16, 16, 3)
    assert calls == [3] * (PORT_CONFIG.num_style_rows - 1) * 2
    single = SynthesisNetwork(params=params_from_reference(params), config=PORT_CONFIG,
                              device="cpu").images_from_vectors(z)
    assert_within_one_step(port_mesh.fetch_to_host(frames), single)
    from gance_tpu.synthesis.runtime import SynthesisNetwork as JaxNetwork

    want = JaxNetwork(params=params, config=JAX_CONFIG,
                      mesh=jax_mesh.create_mesh(n_devices=2)).images_from_vectors(z)
    assert_within_one_step(network.images_from_vectors(z), want)
    assert_within_one_step(network.create_image_vector(z[0]), want[0])


def test_choose_backend():
    assert distributed.choose_backend([("a", []), ("a", [])]) == "gloo"
    assert distributed.choose_backend([("a", ["GPU-0"]), ("a", ["GPU-0"])]) == "gloo"
    assert distributed.choose_backend([("a", ["GPU-0"]), ("a", ["GPU-1"])]) == "nccl"
    assert distributed.choose_backend([("a", ["GPU-0"])]) == "nccl"
    assert distributed.choose_backend([("a", ["GPU-0", "GPU-1"]), ("b", ["GPU-1"])]) == "gloo"


def test_global_batch_is_the_local_batch_in_one_process():
    mesh = port_mesh.create_mesh(devices=["cpu", "cpu"])
    local = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert distributed.global_batch(mesh, local) is not None
    np.testing.assert_array_equal(distributed.global_batch(mesh, local), local)
    rows = distributed.GlobalRows(local, 4, 8)
    np.testing.assert_array_equal(rows.rows(5, 7), local[1:3])
    with pytest.raises(ValueError, match="not this process's"):
        rows.rows(2, 5)
    block = distributed.GlobalRows(np.stack([local, local + 1]), 4, 8, axis=1)
    np.testing.assert_array_equal(block.step(1).rows(4, 8), local + 1)


def test_two_processes_synthesize_the_single_process_frames(tmp_path):
    """Two gloo ranks x two CPU slots: a 4-slot data mesh and a 2x2 network
    mesh spanning the processes. Every rank gets every frame, equal to the
    one-process run over 4 slots of one process (same shards, same sizes)."""
    params = [params_from_reference(jax_params(i)) for i in range(2)]
    rng = np.random.RandomState(9)
    inputs = dict(config=KW, params=params, z=rng.randn(7, 16).astype(np.float32),
                  w=rng.randn(6, PORT_CONFIG.num_style_rows, 16).astype(np.float32),
                  indices=np.array([0, 1, 1, 1, 0, 1, 1]))
    outs = run_workers("synthesis", inputs, tmp_path, world=2, cpu_devices=2)
    mesh = port_mesh.create_mesh(devices=["cpu"] * 4)
    from gance_tpu_torch.parallel.network_parallel import (
        NetworkParallelSynthesis,
        create_network_mesh,
    )

    want = dict(
        sharded=make_sharded_synthesis(mesh, params[0], PORT_CONFIG)(inputs["z"]),
        matrices=SynthesisNetwork(params=params[0], config=PORT_CONFIG, mesh=mesh)
        .images_from_matrices(inputs["w"]),
        network_parallel=NetworkParallelSynthesis(
            params, PORT_CONFIG, mesh=create_network_mesh(2, devices=["cpu"] * 4))
        .synthesize(inputs["z"], inputs["indices"], batch_size=2),
    )
    for rank, out in enumerate(outs):
        assert out["backend"] == "gloo"
        assert "cannot re-init" in out["conflict"]
        assert out["mesh"] == {"data": 4, "model": 1}
        assert out["network_mesh"] == {"network": 2, "data": 2}
        for key, frames in want.items():
            np.testing.assert_array_equal(out[key], frames, err_msg=f"rank {rank} {key}")
