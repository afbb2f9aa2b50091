"""
The port's network-parallel synthesis (gance_tpu_torch.parallel.
network_parallel, `MultiNetwork(network_parallel=True)`) against gance_tpu's,
with the cases of tests/test_network_parallel.py: JAX's runs on the
conftest's 8 virtual CPU devices, the port's on 8 CPU slots of one process.

Bound: 1 uint8 step everywhere and at most 1% of the values off by that
step (JAX's own bound for this mode: each side's convolutions run at other
batch shapes than the other's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.parallel import network_parallel as jax_np  # noqa: E402
from gance_tpu.synthesis.runtime import MultiNetwork as JaxMultiNetwork  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.parallel import network_parallel as port_np  # noqa: E402
from gance_tpu_torch.pipelines import noise_blend as port_nb  # noqa: E402
from gance_tpu_torch.synthesis.runtime import MultiNetwork  # noqa: E402
from tests.torch_parallel_worker import cpu_slots  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
          mapping_layers=2, mapping_fmaps=16)  # tests/test_distributed.py's MODEL
PHASE_KW = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32, dlatent_size=32,
                mapping_layers=2, mapping_fmaps=32)  # a 32-channel top block
N_NETWORKS = 4
EIGHT = ["cpu"] * 8


def jax_params(seed: int, kw=KW):
    return jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(seed), jax_g.GeneratorConfig(**kw)))


@pytest.fixture(scope="module")
def params_list():
    return [jax_params(i) for i in range(N_NETWORKS)]


def port_serving(params_list, n_devices=8, kw=KW, **kwargs):
    mesh = port_np.create_network_mesh(len(params_list), devices=["cpu"] * n_devices)
    return port_np.NetworkParallelSynthesis(
        [params_from_reference(p) for p in params_list], port_g.GeneratorConfig(**kw),
        mesh=mesh, **kwargs)


def jax_serving(params_list, kw=KW, **kwargs):
    return jax_np.NetworkParallelSynthesis(params_list, jax_g.GeneratorConfig(**kw), **kwargs)


def assert_quantization_parity(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) <= max(1, got.size // 100)


def test_mesh_uses_divisible_device_prefix():
    for n in (3, 4, 1):
        want = jax_np.create_network_mesh(n)
        got = port_np.create_network_mesh(n, devices=EIGHT)
        assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    for fn in (lambda: jax_np.create_network_mesh(16),
               lambda: port_np.create_network_mesh(16, devices=EIGHT)):
        with pytest.raises(ValueError, match="at least"):
            fn()


def test_stack_rejects_mismatched_architectures(params_list, tmp_path):
    other = jax_params(9, dict(KW, resolution=32))
    with pytest.raises(ValueError, match="different param structure"):
        jax_np.stack_network_params([params_list[0], other])
    with pytest.raises(ValueError, match="different param structure"):
        port_np.stack_network_params([params_from_reference(params_list[0]),
                                      params_from_reference(other)])
    paths = [tmp_path / "a.pkl", tmp_path / "b.pkl"]
    save_generator_pickle(params_list[0], paths[0])
    save_generator_pickle(jax_params(3, dict(KW, fmap_max=16)), paths[1])
    with pytest.raises(ValueError, match="one shared architecture"):
        port_np.NetworkParallelSynthesis.from_pkls(paths, device="cpu")


def test_stacking_stays_on_host(params_list):
    stacked = port_np.stack_network_params([params_from_reference(p) for p in params_list])
    leaf = stacked["synthesis"]["4x4"]["Conv"]["weight"]
    assert isinstance(leaf, np.ndarray) and leaf.shape[0] == N_NETWORKS


@pytest.mark.parametrize("kind", ["z", "matrices"])
def test_streams_match_jax(params_list, kind):
    rng = np.random.RandomState(0 if kind == "z" else 1)
    n = 30 if kind == "z" else 12
    shape = (n, 16) if kind == "z" else (n, port_g.GeneratorConfig(**KW).num_style_rows, 16)
    frames = rng.randn(*shape).astype(np.float32)
    indices = rng.randint(0, N_NETWORKS, size=n)
    want = jax_serving(params_list, truncation_psi=1.2).synthesize(frames, indices, batch_size=8)
    got = port_serving(params_list, truncation_psi=1.2).synthesize(frames, indices, batch_size=8)
    assert_quantization_parity(got, want)


def test_imbalanced_indices_and_multi_round_dispatch(params_list, monkeypatch):
    """All frames on one network, batch_size 1: 7 rounds of a 2-frame group;
    each round launches one cell per (network, data slot)."""
    from gance_tpu_torch.ops.cuda import fused_ops as K

    rng = np.random.RandomState(2)
    frames = rng.randn(13, 16).astype(np.float32)
    indices = np.full((13,), 2)
    want = jax_serving(params_list).synthesize(frames, indices, batch_size=1)
    serving = port_serving(params_list)
    calls = []
    real = K._fused_bias_noise_lrelu_run
    monkeypatch.setattr(K, "_fused_bias_noise_lrelu_run",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    handle = serving.dispatch(frames, indices, batch_size=1)
    assert len(handle[1]) == 7
    assert calls == [1] * (7 * 8 * (port_g.GeneratorConfig(**KW).num_style_rows - 1))
    assert_quantization_parity(serving.gather(handle), want)


def test_single_network_degenerates_to_data_parallel(params_list):
    serving = port_serving(params_list[:1])
    assert serving.mesh.shape == {"network": 1, "data": 8}
    frames = np.random.RandomState(3).randn(9, 16).astype(np.float32)
    want = jax_serving(params_list[:1]).synthesize(frames, batch_size=4)
    assert_quantization_parity(serving.synthesize(frames, batch_size=4), want)


def test_index_validation_and_empty_input(params_list):
    serving = port_serving(params_list)
    frames = np.zeros((3, 16), np.float32)
    with pytest.raises(ValueError, match="out of range"):
        serving.synthesize(frames, np.array([0, 1, 7]))
    with pytest.raises(ValueError, match="shape"):
        serving.synthesize(frames, np.array([0, 1]))
    assert serving.synthesize(np.zeros((0, 16), np.float32)).shape == (0, 16, 16, 3)
    with pytest.raises(ValueError, match="divide by the data axis"):
        serving.synthesize_grouped(np.zeros((N_NETWORKS, 3, 16), np.float32))


def test_output_side_length_matches_jax(params_list):
    frames = np.random.RandomState(5).randn(8, 16).astype(np.float32)
    indices = np.arange(8) % 4
    want = jax_serving(params_list, output_side_length=24).synthesize(frames, indices, 4)
    got = port_serving(params_list, output_side_length=24).synthesize(frames, indices, 4)
    assert got.shape == (8, 24, 24, 3)
    assert_quantization_parity(got, want)


def test_phase_top_block_under_network_parallel(monkeypatch):
    """The polyphase top block (kernel E's twin, once per cell) per call:
    phase on equals JAX's phase path and the port's standard path within the
    bound."""
    from gance_tpu_torch.ops.cuda import fused_ops as K

    params = [jax_params(i, PHASE_KW) for i in range(2)]
    rng = np.random.RandomState(6)
    frames = rng.randn(8, 32).astype(np.float32)
    indices = rng.randint(0, 2, size=8)
    calls = []
    real = K._phase_conv1_torgb_run
    monkeypatch.setattr(K, "_phase_conv1_torgb_run",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    on = port_serving(params, 4, PHASE_KW, phase_top_block_mode=True).synthesize(frames, indices, 4)
    assert len(calls) == 4  # one round, 2 networks x 2 data slots
    off = port_serving(params, 4, PHASE_KW, phase_top_block_mode=False).synthesize(
        frames, indices, 4)
    want = jax_serving(params, PHASE_KW, phase_top_block_mode=True).synthesize(frames, indices, 4)
    assert_quantization_parity(on, off)
    assert_quantization_parity(on, want)


def test_multinetwork_network_parallel_stream(tmp_path, params_list, monkeypatch):
    """MultiNetwork(network_parallel=True) over 8 CPU slots against JAX's on 8
    devices, the stream and the indexed single-image surface."""
    paths = []
    for i, params in enumerate(params_list):
        paths.append(tmp_path / f"{i}_net.pkl")
        save_generator_pickle(params, paths[-1])
    rng = np.random.RandomState(4)
    frames = rng.randn(21, 16).astype(np.float32)
    indices = rng.randint(0, 4, size=21)
    with JaxMultiNetwork(paths, network_parallel=True) as jax_mode:
        want = jax_mode.synthesize_all(frames, indices, batch_size=4, lookahead=2)
        one_want = jax_mode.indexed_create_image_vector(1, frames[0])
    cpu_slots(8, monkeypatch)
    with MultiNetwork(paths, network_parallel=True, device="cpu") as np_mode:
        got = np_mode.synthesize_all(frames, indices, batch_size=4, lookahead=2)
        one = np_mode.indexed_create_image_vector(1, frames[0])
        assert np_mode.expected_vector_length == 16 and np_mode.network(2).resolution == 16
    assert_quantization_parity(got, want)
    assert_quantization_parity(one, one_want)


def test_placement_flags_and_degrading_guards(monkeypatch, caplog):
    """JAX's conflicts raise the same ValueError; too few devices degrade
    with JAX's warnings."""
    from gance_tpu.pipelines.noise_blend import _resolve_placement as jax_resolve

    for args in [(2, True, False), (None, True, True), (2, False, True)]:
        for resolve in (jax_resolve, lambda *a: port_nb._resolve_placement(*a, device="cpu")):
            with pytest.raises(ValueError, match="mutually exclusive"):
                resolve(*args, [object()] * 2)
    cpu_slots(8, monkeypatch)
    assert port_nb._check_network_parallel(True, [object()] * 4, "cpu") is True
    assert port_nb._check_network_parallel(False, [object()] * 2, "cpu") is False
    cpu_slots(1, monkeypatch)
    with caplog.at_level("WARNING", logger="gance_tpu_torch"):
        assert port_nb._check_network_parallel(True, [object()] * 9, "cpu") is False
        assert port_nb._build_mesh(2, "cpu") is None
    assert "networks > 1 devices" in caplog.text
    assert "only one device is visible" in caplog.text
    mesh, dpn, npar = port_nb._resolve_placement(None, False, False, [object()] * 2, "cpu")
    assert mesh is None and not dpn and not npar
