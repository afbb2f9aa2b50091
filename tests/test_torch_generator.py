"""
The port's generator (gance_tpu_torch.models) against gance_tpu's, on the CPU:
the 32px golden config of tests/test_golden_image.py with the JAX params
carried over by `params_from_reference` and through a JAX-written pickle, a
port-written pickle read by JAX, the pickle loader's guard and network
discovery, mapping and truncation, the noise modes and the uint8 transform.
Tolerances: float images within 1e-4 (fp32, sums in
another order); uint8 images within 1 step, the floor of a value that sits on
a step boundary may flip.
"""

import json
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.models import pickle_loader as jax_loader  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu_torch.models import pickle_loader as port_loader  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402
from tests.test_golden_image import GOLDEN_PIXELS  # noqa: E402

GOLDEN_KW = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32,
                 dlatent_size=32, mapping_layers=2, mapping_fmaps=32)
JAX_CONFIG = jax_g.GeneratorConfig(**GOLDEN_KW)
PORT_CONFIG = port_g.GeneratorConfig(**GOLDEN_KW)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    """JAX golden params (numpy), the golden z and JAX's float and uint8 renders."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(0), JAX_CONFIG))
    z = np.random.RandomState(1234).randn(4, 32).astype(np.float32)
    image = np.asarray(jax_g.generator_apply(params, jnp.asarray(z), JAX_CONFIG, truncation_psi=1.2))
    return params, z, image, np.asarray(jax_g.images_to_uint8(jnp.asarray(image)))


def _port_render(params, z, config=PORT_CONFIG, **kwargs):
    with torch.inference_mode():
        return port_g.generator_apply(
            params_to_device(params, CPU), torch.from_numpy(z), config, **kwargs
        ).numpy()


def _assert_golden(image_float, golden_float, golden_u8):
    np.testing.assert_allclose(image_float, golden_float, rtol=1e-4, atol=1e-4)
    u8 = port_g.images_to_uint8(torch.from_numpy(image_float)).numpy()
    assert u8.shape == (4, 32, 32, 3) and u8.dtype == np.uint8
    assert int(np.abs(u8.astype(int) - golden_u8.astype(int)).max()) <= 1
    for (b, y, x), want in GOLDEN_PIXELS.items():
        assert all(abs(int(g) - w) <= 1 for g, w in zip(u8[b, y, x], want)), (b, y, x)


def test_golden_render_via_params_from_reference(golden):
    params, z, image, u8 = golden
    _assert_golden(_port_render(params_from_reference(params), z), image, u8)


def test_golden_render_via_jax_written_pickle(golden, tmp_path):
    params, z, image, u8 = golden
    path = tmp_path / "golden.pkl"
    jax_loader.save_generator_pickle(params, path)
    port_params, config = port_loader.load_generator(path)
    assert config == PORT_CONFIG
    noise0 = port_params["synthesis"]["noise"]["noise0"]
    assert noise0.shape == (1, 1, 4, 4)  # TF's native NCHW, not transposed
    assert port_params["synthesis"]["4x4"]["Const"]["const"].shape == (1, 64, 4, 4)
    assert port_params["synthesis"]["8x8"]["Conv0_up"]["weight"].shape == (64, 64, 3, 3)
    _assert_golden(_port_render(port_params, z, config), image, u8)


def test_port_written_pickle_loads_in_jax(golden, tmp_path):
    params, z, _, _ = golden
    port_params = params_from_reference(params)
    port_params["dlatent_avg"] = np.linspace(-0.5, 0.5, 32).astype(np.float32)
    path = tmp_path / "port.pkl"
    port_loader.save_generator_pickle(port_params, path)
    jax_params, jax_config = jax_loader.load_generator(path)
    assert jax_config == JAX_CONFIG
    for name, value in params["synthesis"]["noise"].items():
        np.testing.assert_array_equal(jax_params["synthesis"]["noise"][name], value)
    want = np.asarray(jax_g.generator_apply(jax_params, jnp.asarray(z), JAX_CONFIG))
    np.testing.assert_allclose(_port_render(port_params, z), want, rtol=1e-4, atol=1e-4)
    # and back: the port reads its own pickle to the same params
    again, _ = port_loader.load_generator(path)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(port_params)):
        np.testing.assert_array_equal(a, b)


def test_unpickler_blocks_foreign_globals(tmp_path):
    evil = tmp_path / "evil.pkl"
    evil.write_bytes(pickle.dumps({"fn": print}))
    with pytest.raises(pickle.UnpicklingError, match="Blocked global"):
        port_loader.read_network_pickle(evil)


def test_network_discovery_matches_jax(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    for name in ["b.pkl", "a.pkl", "c.txt", "10_x.pkl"]:
        (d / name).write_bytes(b"")
    extra = tmp_path / "extra.pkl"
    extra.write_bytes(b"")
    blob = tmp_path / "nets.json"
    blob.write_text(json.dumps({"networks": [str(extra)]}))
    assert port_loader.sorted_networks_in_directory(d) == jax_loader.sorted_networks_in_directory(d)
    got = port_loader.parse_network_paths(d, [extra], blob)
    assert got == jax_loader.parse_network_paths(d, [extra], blob)
    assert [p.name for p in got] == ["10_x.pkl", "a.pkl", "b.pkl", "extra.pkl", "extra.pkl"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"networks": [str(tmp_path / "missing.pkl")]}))
    for args, match in [((None, None, None), "No networks"), ((None, None, bad), "not a file")]:
        with pytest.raises(ValueError, match=match):
            port_loader.parse_network_paths(*args)


def test_mapping_and_truncation_match_jax(golden):
    params, z, _, _ = golden
    port_params = params_to_device(params_from_reference(params), CPU)
    w_want = np.asarray(jax_g.mapping_apply(params, jnp.asarray(z), JAX_CONFIG))
    w_got = port_g.mapping_apply(port_params, torch.from_numpy(z), PORT_CONFIG)
    np.testing.assert_allclose(w_got.numpy(), w_want, rtol=1e-5, atol=1e-5)
    dl = port_g.broadcast_dlatents(w_got, PORT_CONFIG)
    assert dl.shape == (4, PORT_CONFIG.num_style_rows, 32)
    avg = np.random.RandomState(0).randn(32).astype(np.float32)
    for cutoff in (None, 3):
        want = np.asarray(jax_g.truncate_dlatents(
            jax_g.broadcast_dlatents(jnp.asarray(w_want), JAX_CONFIG), jnp.asarray(avg), 1.2, cutoff))
        got = port_g.truncate_dlatents(dl, torch.from_numpy(avg), 1.2, cutoff)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_synthesis_noise_modes_match_jax(golden, noise_mode):
    params, _, _, _ = golden
    params = jax.tree_util.tree_map(np.copy, params)
    for name, block in params["synthesis"].items():  # make the noise term count
        for layer in block.values() if name != "noise" else ():
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(0.3)
    dl = np.random.RandomState(5).randn(2, PORT_CONFIG.num_style_rows, 32).astype(np.float32)
    want = np.asarray(jax_g.synthesis_apply(params, jnp.asarray(dl), JAX_CONFIG, noise_mode=noise_mode))
    got = port_g.synthesis_apply(
        params_to_device(params_from_reference(params), CPU), torch.from_numpy(dl), PORT_CONFIG,
        noise_mode=noise_mode,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_random_noise_mode_is_seeded_by_the_generator(golden):
    params = params_to_device(params_from_reference(golden[0]), CPU)
    for layer in params["synthesis"]["8x8"].values():
        if "noise_strength" in layer:
            layer["noise_strength"] = torch.tensor(0.5)
    dl = torch.from_numpy(np.random.RandomState(6).randn(2, 8, 32).astype(np.float32))

    def render(seed):
        gen = torch.Generator().manual_seed(seed)
        return port_g.synthesis_apply(params, dl, PORT_CONFIG, noise_mode="random", generator=gen)

    torch.testing.assert_close(render(1), render(1), rtol=0, atol=0)
    assert float((render(1) - render(2)).abs().max()) > 1e-3
    assert float((render(1) - port_g.synthesis_apply(params, dl, PORT_CONFIG)).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="Generator"):
        port_g.synthesis_apply(params, dl, PORT_CONFIG, noise_mode="random")
    with pytest.raises(ValueError, match="noise_mode"):
        port_g.synthesis_apply(params, dl, PORT_CONFIG, noise_mode="fresh")


def test_images_to_uint8_floors_then_clips():
    values = np.array([-2.0, -1.0, -0.001, 0.0, 0.0039, 0.5, 0.9999, 1.0, 3.0], np.float32)
    images = np.broadcast_to(values[:, None, None, None], (9, 2, 2, 3)).copy()
    want = np.asarray(jax_g.images_to_uint8(jnp.asarray(images)))
    got = port_g.images_to_uint8(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 0, 0, 0].tolist() == [0, 0, 127, 128, 128, 191, 255, 255, 255]


def test_init_params_follow_jax_shapes_and_distributions():
    config = port_g.GeneratorConfig(resolution=64, fmap_base=1024, fmap_max=128,
                                    latent_size=64, dlatent_size=64, mapping_layers=3,
                                    mapping_fmaps=64)
    jax_params = jax.tree_util.tree_map(np.asarray, jax_g.init_generator_params(
        jax.random.PRNGKey(0), jax_g.GeneratorConfig(**{
            k: getattr(config, k) for k in ("resolution", "fmap_base", "fmap_max",
                                             "latent_size", "dlatent_size",
                                             "mapping_layers", "mapping_fmaps")})))
    want = params_from_reference(jax_params)
    got = port_g.init_generator_params(0, config)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    got_flat, want_flat = flat(got), flat(want)
    assert got_flat.keys() == want_flat.keys()
    for key, value in got_flat.items():
        assert value.shape == want_flat[key].shape and value.dtype == np.float32, key
    assert abs(float(got["mapping"]["Dense0"]["weight"].std()) - 100.0) < 5.0
    assert abs(float(got["synthesis"]["64x64"]["Conv1"]["weight"].std()) - 1.0) < 0.05
    assert port_g.config_from_params(got) == config
    assert port_g.config_from_params(want) == config
    np.testing.assert_array_equal(
        port_g.init_generator_params(0, config)["synthesis"]["noise"]["noise3"],
        got["synthesis"]["noise"]["noise3"])


def test_config_f_defaults_match_jax():
    port, ref = port_g.GeneratorConfig(), jax_g.GeneratorConfig()
    assert port.num_style_rows == ref.num_style_rows == 18
    assert port.block_resolutions() == ref.block_resolutions()
    assert [port.nf(s) for s in range(1, 10)] == [ref.nf(s) for s in range(1, 10)]
    assert port.resample_kernel == ref.resample_kernel
    assert port_g.DEFAULT_TRUNCATION_PSI == jax_g.DEFAULT_TRUNCATION_PSI


def test_bf16_compute_close_to_fp32(golden):
    """The bf16 tier, at the bound tests/test_bf16_fidelity.py sets for JAX."""
    params, z, _, _ = golden
    port_params = params_from_reference(params)
    f32 = port_g.images_to_uint8(torch.from_numpy(_port_render(port_params, z))).numpy()
    bf16 = port_g.images_to_uint8(torch.from_numpy(
        _port_render(port_params, z, compute_dtype=torch.bfloat16))).numpy()
    diff = np.abs(f32.astype(int) - bf16.astype(int))
    assert diff.mean() < 2.0 and np.percentile(diff, 99) <= 8 and diff.max() <= 64
