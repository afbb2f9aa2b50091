"""
The port's perceptual metric (gance_tpu_torch/projection/lpips.py), its weight
import (vgg_import.py) and the projector's target resize against gance_tpu's,
on the CPU, with the same numpy inputs handed to both. The port works in
NCHW/OIHW and JAX in NHWC/HWIO, so images are transposed at the boundary.

Tolerances, each with its reason:
  * weights (random VGG, every importer): byte-equal (the same numpy code);
  * VGG features and LPIPS distances: 1e-5 relative to the output's scale
    (13 fp32 convolutions summed in another order);
  * downsample_to and the linear resize: 1e-6 absolute on values in [-1, 1]
    (the same weights; one sum of 2 to 16 terms in another order).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.projection import lpips as jax_lpips  # noqa: E402
from gance_tpu.projection import vgg_import as jax_vgg  # noqa: E402
from gance_tpu_torch.models.stylegan2 import resize_images  # noqa: E402
from gance_tpu_torch.projection import lpips as port_lpips  # noqa: E402
from gance_tpu_torch.projection import vgg_import as port_vgg  # noqa: E402
from tests.test_vgg_import import _synthetic_state_dict, _write_nvlabs_lpips_pickle  # noqa: E402

CPU = torch.device("cpu")


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def true_lpips_params(rng: np.random.RandomState) -> dict:
    """He-scaled fabricated NVlabs variables through JAX's converter: conv
    weights, Zhang's lin weights and input shift and scale."""
    return jax_vgg.convert_nvlabs_lpips(
        jax_vgg.fabricate_nvlabs_lpips_variables(rng, he_scaled=True))


def assert_same_params(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("seed", [0, 3])
def test_random_vgg_params_byte_equal(seed):
    assert_same_params(port_lpips.random_vgg_params(seed), jax_lpips.random_vgg_params(seed))


def test_constants_match():
    assert port_lpips.VGG16_BLOCKS == jax_lpips.VGG16_BLOCKS
    assert port_lpips.DEFAULT_FEATURE_BLOCKS == jax_lpips.DEFAULT_FEATURE_BLOCKS
    np.testing.assert_array_equal(port_lpips.ZHANG_INPUT_SHIFT, jax_lpips.ZHANG_INPUT_SHIFT)
    np.testing.assert_array_equal(port_lpips.ZHANG_INPUT_SCALE, jax_lpips.ZHANG_INPUT_SCALE)


@pytest.mark.parametrize("weights", ["random", "true-lpips"])
def test_vgg_features_match_jax(weights):
    rng = np.random.RandomState(7)
    params = port_lpips.random_vgg_params(1) if weights == "random" else true_lpips_params(rng)
    images = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    want = jax_lpips.vgg_features(params, jnp.asarray(images))
    got = port_lpips.vgg_features(port_lpips.vgg_params_to_device(params, CPU), nchw(images))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("weights", ["random", "true-lpips"])
@pytest.mark.parametrize("feature_blocks", [(0, 1, 2, 3, 4), (4, 2)])
def test_lpips_distance_matches_jax(weights, feature_blocks):
    rng = np.random.RandomState(8)
    params = port_lpips.random_vgg_params(2) if weights == "random" else true_lpips_params(rng)
    a = (rng.rand(3, 32, 32, 3) * 2 - 1).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    want = np.asarray(jax_lpips.lpips_distance(params, jnp.asarray(a), jnp.asarray(b),
                                               feature_blocks))
    device_params = port_lpips.vgg_params_to_device(params, CPU)
    got = port_lpips.lpips_distance(device_params, nchw(a), nchw(b), feature_blocks).numpy()
    assert got.shape == (3,) and float(want.min()) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    same = port_lpips.lpips_distance(device_params, nchw(a), nchw(a), feature_blocks)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_vgg_params_to_device_transposes_convs_only():
    params = true_lpips_params(np.random.RandomState(2))
    placed = port_lpips.vgg_params_to_device(params, CPU)
    assert tuple(placed["block1_conv0_w"].shape) == (128, 64, 3, 3)
    np.testing.assert_array_equal(placed["block1_conv0_w"].numpy(),
                                  params["block1_conv0_w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(placed["lin3_w"].numpy(), params["lin3_w"])
    np.testing.assert_array_equal(placed["input_scale"].numpy(), params["input_scale"])


@pytest.mark.parametrize("side,size", [(64, 16), (32, 32), (16, 32)])
def test_downsample_to_matches_jax(side, size):
    images = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax_lpips.downsample_to(jnp.asarray(images), size)).transpose(0, 3, 1, 2)
    got = port_lpips.downsample_to(nchw(images), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("in_size,side", [(40, 16), (37, 16), (16, 40), (10, 16), (24, 16)])
def test_linear_resize_matches_jax_image_resize(in_size, side):
    """The projector's target resize: jax.image.resize(method="linear"), a
    triangle filter widened by the scale on a downscale (antialiased), which
    F.interpolate(mode="bilinear") is not."""
    images = np.random.RandomState(in_size).rand(2, in_size, in_size, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax.image.resize(jnp.asarray(images), (2, side, side, 3), "linear"))
    got = resize_images(torch.from_numpy(images), side, method="linear").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if in_size > side:  # not bilinear interpolation
        plain = torch.nn.functional.interpolate(nchw(images), size=(side, side), mode="bilinear",
                                                align_corners=False)
        assert float(np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max()) > 1e-3


@pytest.mark.parametrize("lin_layout", ["4d", "2d"])
def test_convert_nvlabs_lpips_byte_equal(lin_layout):
    variables = jax_vgg.fabricate_nvlabs_lpips_variables(np.random.RandomState(4), lin_layout)
    assert_same_params(port_vgg.fabricate_nvlabs_lpips_variables(
        np.random.RandomState(4), lin_layout), variables)
    assert_same_params(port_vgg.convert_nvlabs_lpips(variables),
                       jax_vgg.convert_nvlabs_lpips(variables))


def test_convert_nvlabs_lpips_autonumbered_scopes_byte_equal():
    """TF's Conv2D, Conv2D_1 ... Conv2D_12 scopes sort in forward order in both."""
    variables = jax_vgg.fabricate_nvlabs_lpips_variables(np.random.RandomState(6))
    renamed = {}
    for name, value in variables.items():
        scope, leaf = name.split("/")
        if scope in jax_vgg.NVLABS_CONV_SCOPES:
            position = jax_vgg.NVLABS_CONV_SCOPES.index(scope)
            scope = "Conv2D" if position == 0 else f"Conv2D_{position}"
        renamed[f"{scope}/{leaf}"] = value
    got = port_vgg.convert_nvlabs_lpips(renamed)
    assert_same_params(got, jax_vgg.convert_nvlabs_lpips(renamed))
    np.testing.assert_array_equal(got["block3_conv1_w"], variables["conv4_2/weight"])


def test_convert_torchvision_vgg16_byte_equal():
    state = _synthetic_state_dict(np.random.RandomState(5))
    assert_same_params(port_vgg.convert_torchvision_vgg16(state),
                       jax_vgg.convert_torchvision_vgg16(state))
    as_tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    assert_same_params(port_vgg.convert_torchvision_vgg16(as_tensors),
                       jax_vgg.convert_torchvision_vgg16(state))


@pytest.mark.parametrize("case", ["wrong-channels", "missing-conv"])
def test_converters_raise_like_jax(case):
    rng = np.random.RandomState(9)
    if case == "wrong-channels":
        state = _synthetic_state_dict(rng)
        state["features.0.weight"] = state["features.0.weight"][:32]
        convert = (port_vgg.convert_torchvision_vgg16, jax_vgg.convert_torchvision_vgg16)
        arg, match = state, "expected 64 out channels"
    else:
        variables = jax_vgg.fabricate_nvlabs_lpips_variables(rng)
        del variables["conv4_2/weight"], variables["conv4_2/bias"]
        convert = (port_vgg.convert_nvlabs_lpips, jax_vgg.convert_nvlabs_lpips)
        arg, match = variables, "lacks"
    for fn in convert:
        with pytest.raises(ValueError, match=match):
            fn(arg)


@pytest.mark.parametrize("lin_layout", ["4d", "2d"])
def test_nvlabs_pickle_and_npz_import_byte_equal(tmp_path, lin_layout):
    """The pickle read through the port's own capture-only unpickler, the
    loader's .pkl and .npz routes and import_vgg_weights's .npz all give JAX's
    params, byte for byte."""
    variables = jax_vgg.fabricate_nvlabs_lpips_variables(np.random.RandomState(3), lin_layout)
    pkl = tmp_path / "vgg16_zhang_perceptual.pkl"
    _write_nvlabs_lpips_pickle(pkl, variables)
    want = jax_vgg.load_nvlabs_lpips_pickle(pkl)
    assert_same_params(port_vgg.load_nvlabs_lpips_pickle(pkl), want)
    assert_same_params(port_lpips.load_vgg_params(pkl), want)
    npz = tmp_path / "vgg.npz"
    port_vgg.import_vgg_weights(pkl, npz)
    assert_same_params(port_lpips.load_vgg_params(npz), jax_lpips.load_vgg_params(npz))
    assert_same_params(port_lpips.load_vgg_params(npz), want)


def test_import_vgg_weights_from_torch_checkpoint(tmp_path):
    state = _synthetic_state_dict(np.random.RandomState(11))
    checkpoint = tmp_path / "vgg16.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, checkpoint)
    got, want = tmp_path / "port.npz", tmp_path / "jax.npz"
    port_vgg.import_vgg_weights(checkpoint, got)
    jax_vgg.import_vgg_weights(checkpoint, want)
    assert_same_params(port_lpips.load_vgg_params(got), jax_lpips.load_vgg_params(want))
