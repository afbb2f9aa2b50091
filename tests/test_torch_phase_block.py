"""
The port's polyphase top block (gance_tpu_torch/ops/phase_block.py), kernel
E's plain twin and `resize_images` against gance_tpu's, on the CPU, with the
same numpy inputs handed to both. The port works in NCHW/OIHW and JAX in
NHWC/HWIO, so tensors are transposed at the boundary.

Tolerances, each with its reason:
  * folds, splits and interleaves: exact (the same products and copies);
  * E's twin against the Pallas kernel in interpret mode: atol 2e-4 and rtol
    1e-4, the tolerance of tests/test_phase_fused.py (a 4C*4-term fp32 sum,
    then a 4C-term one, in another order);
  * phase_top_block float output: 5e-5, the JAX phase tests' tolerance
    (the same operator, reassociated);
  * uint8 frames: within 1 step on at least 99.9% of pixels (a float that
    differs in its last bits may floor to the neighbouring step);
  * resize_images: 1e-5 (the same weights; JAX contracts the two axes in one
    einsum, the port in two products);
  * the dlatent gradient through the phase path (kernel E's Function)
    against jax.grad of JAX's phase path and the port's standard path: 1e-4
    of the gradient's scale (the same operator, reassociated).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.ops import phase_block as jax_pb  # noqa: E402
from gance_tpu.ops.pallas.phase_fused import phase_conv1_torgb_fused  # noqa: E402
from gance_tpu.ops.upfirdn2d import upsample2x_phases_nchw as jax_phases  # noqa: E402
from gance_tpu.synthesis import runtime as jax_rt  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.ops import phase_block as port_pb  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402
from gance_tpu_torch.ops.upfirdn2d import upsample2x_phases_nchw  # noqa: E402
from gance_tpu_torch.synthesis import runtime as port_rt  # noqa: E402
from gance_tpu_torch.synthesis.runtime import params_to_device  # noqa: E402

RK = (1, 3, 3, 1)
CPU = torch.device("cpu")
# (resolution, fmap_base) of tests/test_phase_block.py: top-block cout 16, 8, 48
BLOCK_CONFIGS = [(64, 1024), (8, 256), (32, 768)]


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def hwio(w: torch.Tensor) -> np.ndarray:
    return w.permute(2, 3, 1, 0).numpy()


def assert_uint8_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    steps = np.abs(got.astype(int) - want.astype(int))
    assert int(steps.max()) <= 1
    assert float(np.mean(steps == 0)) >= 0.999


def test_fold_upconv_blur_weights_matches_jax(rng):
    w = rng.randn(3, 3, 5, 7).astype(np.float32)
    root = port_pb.resample_root(RK)
    np.testing.assert_array_equal(root, jax_pb.resample_root(RK))
    want = np.asarray(jax_pb.fold_upconv_blur_weights(jnp.asarray(w), root))  # (3,3,5,28)
    got = port_pb.fold_upconv_blur_weights(oihw(w), root)  # (28, 5, 3, 3)
    assert tuple(got.shape) == (28, 5, 3, 3)
    np.testing.assert_allclose(hwio(got), want, rtol=1e-6, atol=1e-6)


def test_fold_conv1_weights_matches_jax(rng):
    v = rng.randn(3, 3, 6, 4).astype(np.float32)
    want = np.asarray(jax_pb.fold_conv1_weights(jnp.asarray(v)))  # (2,2,24,16)
    got = port_pb.fold_conv1_weights(oihw(v))  # (16, 24, 2, 2)
    assert tuple(got.shape) == (16, 24, 2, 2)
    np.testing.assert_array_equal(hwio(got), want)


@pytest.mark.parametrize("shifted", [False, True])
def test_phase_splits_match_jax(rng, shifted):
    fine = rng.randn(2, 8, 6, 1).astype(np.float32)
    jax_fn = jax_pb.phase_split_fine_shifted if shifted else jax_pb.phase_split_fine
    port_fn = port_pb.phase_split_fine_shifted if shifted else port_pb.phase_split_fine
    want = np.asarray(jax_fn(jnp.asarray(fine)))
    got = port_fn(nchw(fine))
    np.testing.assert_array_equal(nhwc(got), want)


def test_interleaves_match_jax(rng):
    rgb_ph = rng.randn(2, 7, 5, 12).astype(np.float32)  # Conv1 convention, h=12, w=8
    want = np.asarray(jax_pb.interleave_phases_nchw(jnp.asarray(rgb_ph), 12, 8))
    np.testing.assert_array_equal(port_pb.interleave_phases_nchw(nchw(rgb_ph), 12, 8).numpy(), want)
    x_ph = rng.randn(2, 5, 7, 20).astype(np.float32)  # upconv convention, h=10, w=14
    want = np.asarray(jax_pb.interleave_phases_nhwc(jnp.asarray(x_ph), 10, 14))
    np.testing.assert_array_equal(nhwc(port_pb.interleave_phases_nhwc(nchw(x_ph), 10, 14)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_phases_match_kernel_b_bit_for_bit(rng, dtype):
    """The un-interleaved phases equal kernel B's interleaved output exactly,
    and JAX's phases in fp32."""
    x = rng.randn(2, 3, 9, 13).astype(np.float32)
    root = tuple(float(v) for v in port_pb.resample_root(RK))
    xt = torch.from_numpy(x).to(dtype)
    fine = K.upsample2x_blur(xt, root)
    phases = upsample2x_phases_nchw(xt, root)
    want_jax = jax_phases(jnp.asarray(x), np.asarray(root))
    for index, (i, j) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        assert phases[index].dtype == dtype
        torch.testing.assert_close(phases[index], fine[:, :, i::2, j::2], rtol=0, atol=0)
        if dtype == torch.float32:
            np.testing.assert_array_equal(phases[index].numpy(), np.asarray(want_jax[index]))


def _e_inputs(rng, b, h, c4, nb_batch=1):
    """E's operands in JAX's layouts; v is the HWIO Conv1 weight whose fold is
    E's w4 (JAX's `fold_conv1_weights` for the Pallas function, the port's for
    its wrapper)."""
    x = (rng.randn(b, h, h, c4) * 0.5).astype(np.float32)
    v = (rng.randn(3, 3, c4 // 4, c4 // 4) * 0.1).astype(np.float32)
    wrgb = (rng.randn(b, c4, 16) * 0.1).astype(np.float32)
    wrgb[:, :, 12:] = 0.0
    demod = (rng.rand(b, c4) + 0.5).astype(np.float32)
    nb = (rng.randn(nb_batch, h + 1, h + 1, c4) * 0.1).astype(np.float32)
    return x, v, wrgb, demod, nb


def _e_port(x, v, wrgb, demod, nb):
    return K.phase_conv1_torgb(nchw(x), port_pb.fold_conv1_weights(oihw(v)),
                               torch.from_numpy(demod), nchw(nb), torch.from_numpy(wrgb))


def test_phase_conv1_torgb_twin_matches_pallas(rng):
    """E's twin (through its wrapper's CPU dispatch) against the Pallas kernel
    in interpret mode, at the kernel's 512^2 shape with C4 = 8."""
    x, v, wrgb, demod, nb = _e_inputs(rng, 1, 512, 8)
    w4 = jax_pb.fold_conv1_weights(jnp.asarray(v))
    want = np.asarray(phase_conv1_torgb_fused(
        jnp.asarray(x), w4, jnp.asarray(wrgb), jnp.asarray(demod),
        jnp.asarray(nb), interpret=True))
    before = dict(K.LAUNCHES)
    got = _e_port(x, v, wrgb, demod, nb)
    assert K.LAUNCHES == before
    assert tuple(got.shape) == (1, 16, 513, 513)
    np.testing.assert_allclose(nhwc(got), want, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(got, K.phase_conv1_torgb_plain(
        nchw(x), port_pb.fold_conv1_weights(oihw(v)), torch.from_numpy(demod), nchw(nb),
        torch.from_numpy(wrgb)), rtol=0, atol=0)


@pytest.mark.parametrize("h,c4", [(5, 12), (8, 8)])
def test_phase_conv1_torgb_twin_per_sample_noise_bias(rng, h, c4):
    """A (B, ...) noise_bias gives each image its own; (1, ...) is shared. Both
    agree with the composed formulation of tests/test_phase_fused.py."""
    x, v, wrgb, demod, nb = _e_inputs(rng, 3, h, c4, nb_batch=3)
    got = _e_port(x, v, wrgb, demod, nb)
    w4 = jax_pb.fold_conv1_weights(jnp.asarray(v))
    z = jax.lax.conv_general_dilated(jnp.asarray(x), w4, (1, 1), ((1, 1), (1, 1)),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    z = z * jnp.asarray(demod)[:, None, None, :] + jnp.asarray(nb)
    z = jnp.maximum(z, z * 0.2)
    want = np.asarray(jnp.einsum("bmnc,bck->bmnk", z, jnp.asarray(wrgb)))
    np.testing.assert_allclose(nhwc(got), want, atol=2e-4, rtol=1e-4)
    shared = _e_port(x, v, wrgb, demod, nb[1:2])
    torch.testing.assert_close(shared[1], got[1], rtol=0, atol=0)
    assert float((shared[0] - got[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("cout,cin", [(4, 4), (5, 3), (64, 64)])
def test_unfold_conv1_weights_recovers_the_taps_exactly(rng, cout, cin):
    """Kernel E's nine taps are exact slices of the fold: unfold(fold(v)) == v."""
    v = torch.from_numpy(rng.randn(cout, cin, 3, 3).astype(np.float32))
    w4 = port_pb.fold_conv1_weights(v)
    torch.testing.assert_close(K.unfold_conv1_weights(w4), v, rtol=0, atol=0)
    # 28 of the 64 (out-phase, in-phase, kh, kw) blocks are zero
    blocks = w4.reshape(4, cout, 4, cin, 2, 2).permute(0, 2, 4, 5, 1, 3).reshape(64, -1)
    assert int((blocks.abs().amax(dim=1) == 0).sum()) == 28


@pytest.mark.parametrize("breakage", ["dense", "zero_block", "phase_tap"])
def test_phase_conv1_torgb_refuses_a_w4_that_is_not_a_fold(rng, breakage):
    """E takes only the nine taps, so any other w4 would be computed wrongly:
    a random dense w4, a fold with one entry of a zero block set, and a fold
    whose output phase 3 disagrees with phase 0 on one tap all raise."""
    x, v, wrgb, demod, nb = _e_inputs(rng, 1, 4, 8)
    w4 = port_pb.fold_conv1_weights(oihw(v))
    if breakage == "dense":
        w4 = torch.from_numpy(rng.randn(8, 8, 2, 2).astype(np.float32))
    elif breakage == "zero_block":
        w4[0, 0, 0, 0] = 0.5  # out-phase 0, in-phase 0, (kh, kw) = (0, 0): no tap
    else:
        w4[6, 1, 1, 1] += 0.5  # out-phase 3's copy of tap (2, 2), from in-phase 0
    with pytest.raises(ValueError, match="not a Conv1 fold"):
        K.phase_conv1_torgb(nchw(x), w4, torch.from_numpy(demod), nchw(nb),
                            torch.from_numpy(wrgb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_conv1_torgb_taps_mirror_matches_twin(rng, dtype):
    """Kernel E's index map (nine taps over the fine-grid halo, four output
    phases read back at a = 2m + 1 - sigma) against the dense twin on the
    fold, at a ragged shape (C = 5, H != W, per-sample noise_bias). fp32: the
    same terms in another order, 1e-5 of the output's scale; bf16: z rounds
    to bf16 before ToRGB and may round the other way, 1e-2 of the scale."""
    b, c4, h, w = 2, 20, 5, 7
    x = torch.from_numpy((rng.randn(b, c4, h, w) * 0.5).astype(np.float32)).to(dtype)
    v = torch.from_numpy((rng.randn(c4 // 4, c4 // 4, 3, 3) * 0.2).astype(np.float32))
    demod = torch.from_numpy((rng.rand(b, c4) + 0.5).astype(np.float32))
    nb = torch.from_numpy((rng.randn(b, c4, h + 1, w + 1) * 0.1).astype(np.float32))
    wrgb = torch.from_numpy((rng.randn(b, c4, 16) * 0.2).astype(np.float32))
    got = K.phase_conv1_torgb_taps_plain(x, v, demod, nb, wrgb)
    want = K.phase_conv1_torgb_plain(x, port_pb.fold_conv1_weights(v), demod, nb, wrgb)
    assert got.shape == want.shape == (b, 16, h + 1, w + 1) and got.dtype == dtype
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()), err


def test_phase_conv1_torgb_rejects_bad_inputs():
    x = torch.zeros(2, 8, 4, 4)
    args = dict(w4=torch.zeros(8, 8, 2, 2), demod=torch.zeros(2, 8),
                noise_bias=torch.zeros(1, 8, 5, 5), wrgb=torch.zeros(2, 8, 16))
    for key, bad in [("w4", torch.zeros(8, 8, 3, 3)), ("demod", torch.zeros(1, 8)),
                     ("noise_bias", torch.zeros(3, 8, 5, 5)), ("wrgb", torch.zeros(2, 8, 12))]:
        with pytest.raises(ValueError, match="bad shapes"):
            K.phase_conv1_torgb(x, **{**args, key: bad})
    with pytest.raises(ValueError, match="multiple of 4"):
        K.phase_conv1_torgb(torch.zeros(1, 6, 4, 4), torch.zeros(6, 6, 2, 2), torch.zeros(1, 6),
                            torch.zeros(1, 6, 5, 5), torch.zeros(1, 6, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        K.phase_conv1_torgb(x.to("meta"), **{k: v.to("meta") for k, v in args.items()})


def _block_case(resolution, fmap_base, noise_mode, seed=0):
    """JAX params (numpy, non-zero noise strengths and biases) for a config, its
    top block's inputs, and the port's copies."""
    config = jax_g.GeneratorConfig(resolution=resolution, fmap_base=fmap_base)
    params = jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(seed), config))
    rng = np.random.RandomState(seed + 7)
    top = f"{resolution}x{resolution}"
    block = jax.tree_util.tree_map(np.copy, params["synthesis"][top])
    for layer in block.values():
        layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
        if "noise_strength" in layer:
            layer["noise_strength"] = np.float32(rng.uniform(0.1, 0.4))
    b, h = 2, resolution // 2
    cin = block["Conv0_up"]["weight"].shape[2]
    x = rng.randn(b, h, h, cin).astype(np.float32)
    rows = [rng.randn(b, config.dlatent_size).astype(np.float32) for _ in range(3)]
    noise = {
        "const": [rng.randn(1, 2 * h, 2 * h, 1).astype(np.float32) for _ in range(2)],
        "random": [rng.randn(b, 2 * h, 2 * h, 1).astype(np.float32) for _ in range(2)],
        "none": [None, None],
    }[noise_mode]
    port_block = params_to_device(params_from_reference({
        "mapping": {}, "synthesis": {top: block}, "dlatent_avg": np.zeros(1)})["synthesis"][top],
        CPU)
    port_args = (nchw(x), port_block, tuple(torch.from_numpy(r) for r in rows),
                 *[None if n is None else nchw(n) for n in noise])
    jax_args = (jnp.asarray(x), block, tuple(jnp.asarray(r) for r in rows),
                *[None if n is None else jnp.asarray(n) for n in noise])
    return config, rng, port_args, jax_args


@pytest.mark.parametrize("noise_mode", ["const", "none", "random"])
@pytest.mark.parametrize("resolution,fmap_base", BLOCK_CONFIGS)
def test_phase_top_block_matches_jax(resolution, fmap_base, noise_mode):
    config, rng, port_args, jax_args = _block_case(resolution, fmap_base, noise_mode)
    y_up = rng.randn(2, 3, resolution, resolution).astype(np.float32)
    want = np.asarray(jax_pb.phase_top_block(*jax_args, jnp.asarray(y_up), RK, jnp.float32))
    got = port_pb.phase_top_block(*port_args, torch.from_numpy(y_up), RK, torch.float32)
    assert tuple(got.shape) == (2, 3, resolution, resolution)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("noise_mode", ["const", "none", "random"])
@pytest.mark.parametrize("resolution,fmap_base", BLOCK_CONFIGS)
def test_phase_top_block_uint8_matches_jax_and_float_form(resolution, fmap_base, noise_mode):
    """The fused uint8 form: near JAX's, and bit for bit the port's own float
    form followed by images_to_uint8."""
    config, rng, port_args, jax_args = _block_case(resolution, fmap_base, noise_mode, seed=1)
    y = (0.3 * rng.randn(2, 3, resolution // 2, resolution // 2)).astype(np.float32)
    want = np.asarray(jax_pb.phase_top_block_uint8(*jax_args, jnp.asarray(y), RK, jnp.float32))
    got = port_pb.phase_top_block_uint8(*port_args, torch.from_numpy(y), RK, torch.float32)
    assert_uint8_close(got.numpy(), want)
    y_up = port_g.upsample_2d_nchw(torch.from_numpy(y), kernel=RK)
    fine = port_pb.phase_top_block(*port_args, y_up, RK, torch.float32)
    torch.testing.assert_close(got, port_g.images_to_uint8(fine.permute(0, 2, 3, 1)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("form", ["blockdiag", "split", "other"])
def test_uint8_rgb_env_forms(monkeypatch, form):
    """Both TPU forms of the ToRGB contraction give the same frame; others raise."""
    _, rng, port_args, _ = _block_case(8, 256, "const")
    y = rng.randn(2, 3, 4, 4).astype(np.float32)
    reference = port_pb.phase_top_block_uint8(*port_args, torch.from_numpy(y), RK, torch.float32)
    monkeypatch.setenv("GANCE_TPU_UINT8_RGB", form)
    if form == "other":
        with pytest.raises(ValueError, match="GANCE_TPU_UINT8_RGB"):
            port_pb.phase_top_block_uint8(*port_args, torch.from_numpy(y), RK, torch.float32)
        return
    got = port_pb.phase_top_block_uint8(*port_args, torch.from_numpy(y), RK, torch.float32)
    torch.testing.assert_close(got, reference, rtol=0, atol=0)


@pytest.mark.parametrize("side,in_size", [(16, 32), (24, 32), (48, 32), (7, 16)])
def test_resize_images_matches_jax(rng, side, in_size):
    """Downscale (antialiased) and upscale against jax.image.resize(method="cubic")."""
    images = rng.uniform(-1, 1, (2, in_size, in_size, 3)).astype(np.float32)
    want = np.asarray(jax_g.resize_images(jnp.asarray(images), side))
    got = port_g.resize_images(torch.from_numpy(images), side)
    assert tuple(got.shape) == (2, side, side, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_cubic_resize_matrix_columns_sum_to_one():
    for in_size, out_size in [(1024, 512), (64, 100), (5, 3)]:
        w = port_g.cubic_resize_matrix(in_size, out_size)
        assert w.shape == (in_size, out_size) and w.dtype == np.float32
        assert not w.flags.writeable
        np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-5)


def test_phase_mode_resolution(monkeypatch):
    """'auto' is off on the port's devices; 'on' or mode=True forces the path
    where the top block has fewer than 128 channels and the FIR and channel
    count fit it; mode=False wins over the environment."""
    config = port_g.GeneratorConfig(resolution=64, fmap_base=1024)
    for mode, want in [("auto", False), ("on", True), ("off", False), (" ON ", True)]:
        monkeypatch.setenv("GANCE_TPU_PHASE1024", mode)
        assert port_g.resolve_phase_top_block(config) is want
    assert port_g.resolve_phase_top_block(config, True)
    assert not port_g.resolve_phase_top_block(config, False)
    monkeypatch.setenv("GANCE_TPU_PHASE1024", "on")
    assert not port_g.resolve_phase_top_block(config, False)
    for other in [dict(resample_kernel=(1, 2, 1)), dict(resample_kernel=(1, 2, 3, 4)),
                  dict(num_channels=5), dict(fmap_base=2048)]:
        assert not port_g.resolve_phase_top_block(
            port_g.GeneratorConfig(**{"resolution": 32, "fmap_base": 256, **other}))
    monkeypatch.setenv("GANCE_TPU_PHASE1024", "1")
    with pytest.raises(ValueError, match="GANCE_TPU_PHASE1024"):
        port_g.phase_mode_from_env()


SMALL = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32, dlatent_size=32,
             mapping_layers=2, mapping_fmaps=32)


@pytest.fixture(scope="module")
def small_network(tmp_path_factory):
    """A 32px network (top block cout 32) with non-zero noise strengths, biases
    and dlatent_avg, written as a TF-format pickle."""
    config = jax_g.GeneratorConfig(**SMALL)
    params = jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(4), config))
    params = jax.tree_util.tree_map(np.copy, params)
    rng = np.random.RandomState(4)
    for name, block in params["synthesis"].items():
        for layer in block.values() if name != "noise" else ():
            if "bias" in layer:
                layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(rng.uniform(0.1, 0.3))
    params["dlatent_avg"] = (0.3 * rng.randn(32)).astype(np.float32)
    path = tmp_path_factory.mktemp("phase_net") / "net.pkl"
    save_generator_pickle(params, path)
    return path, params, config


@pytest.mark.parametrize("phase", ["on", "off"])
@pytest.mark.parametrize("side", [None, 24])
def test_synthesis_network_phase_and_resize_match_jax(monkeypatch, small_network, phase, side):
    path, _, _ = small_network
    monkeypatch.setenv("GANCE_TPU_PHASE1024", phase)
    port = port_rt.SynthesisNetwork.from_pkl(path, device="cpu", output_side_length=side)
    ref = jax_rt.SynthesisNetwork.from_pkl(path, output_side_length=side)
    rng = np.random.RandomState(9)
    z = rng.randn(3, 32).astype(np.float32)
    mats = rng.randn(2, 8, 32).astype(np.float32)
    out_side = side or 32
    for got, want in [(port.images_from_vectors(z), ref.images_from_vectors(z)),
                      (port.images_from_matrices(mats), ref.images_from_matrices(mats))]:
        assert got.shape[1:] == (out_side, out_side, 3)
        assert_uint8_close(got, want)


def test_phase_path_matches_standard_path(small_network):
    """The phase path and the standard path of one network: float images within
    5e-5, for const and per-sample random noise (the same draws reach both);
    and the phase path against JAX's phase path."""
    _, params, config = small_network
    port_config = port_g.GeneratorConfig(**SMALL)
    tparams = params_to_device(params_from_reference(params), CPU)
    dl = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 32).astype(np.float32))
    for noise_mode in ("const", "random"):
        renders = []
        for phase in (False, True):
            gen = torch.Generator().manual_seed(5)
            renders.append(port_g.synthesis_apply(
                tparams, dl, port_config, noise_mode=noise_mode, generator=gen,
                phase_top_block_mode=phase))
        np.testing.assert_allclose(renders[1].numpy(), renders[0].numpy(), atol=5e-5, rtol=0)
    want = np.asarray(jax_g.synthesis_apply(params, jnp.asarray(dl.numpy()), config,
                                            phase_top_block_mode=True))
    got = port_g.synthesis_apply(tparams, dl, port_config, phase_top_block_mode=True)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_phase_path_dlatent_gradient_matches_jax_and_standard_path(small_network, noise_mode):
    """The gradient of sum(images * probe) with respect to the dlatents
    through the port's phase path (kernel E's Function) against jax.grad of
    JAX's phase path (XLA's phase_top_block) on the same params, and against
    the port's standard path: within 1e-4 of the gradient's scale (the same
    operator, reassociated)."""
    _, params, config = small_network
    port_config = port_g.GeneratorConfig(**SMALL)
    tparams = params_to_device(params_from_reference(params), CPU)
    rng = np.random.RandomState(6)
    dl = rng.randn(2, 8, 32).astype(np.float32)
    probe = rng.randn(2, 32, 32, 3).astype(np.float32)

    def port_grad(phase):
        d = torch.tensor(dl, requires_grad=True)
        images = port_g.synthesis_apply(tparams, d, port_config, noise_mode=noise_mode,
                                        phase_top_block_mode=phase)
        (grad,) = torch.autograd.grad((images * torch.from_numpy(probe)).sum(), d)
        return grad.numpy()

    want = np.asarray(jax.grad(lambda d: jnp.sum(jax_g.synthesis_apply(
        params, d, config, noise_mode=noise_mode, phase_top_block_mode=True) * probe))(
            jnp.asarray(dl)))
    got = port_grad(True)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, port_grad(False), rtol=0, atol=1e-4 * scale)


def test_multi_network_passes_output_side_length(monkeypatch, small_network):
    path, _, _ = small_network
    monkeypatch.setenv("GANCE_TPU_PHASE1024", "on")
    frames = np.random.RandomState(3).randn(5, 32).astype(np.float32)
    with port_rt.MultiNetwork([path, path], device="cpu", output_side_length=16) as port:
        got = port.synthesize_all(frames, np.array([0, 1, 0, 1, 1]), batch_size=2)
    with jax_rt.MultiNetwork([path, path], output_side_length=16) as ref:
        want = ref.synthesize_all(frames, np.array([0, 1, 0, 1, 1]), batch_size=2)
    assert got.shape == (5, 16, 16, 3)
    assert_uint8_close(got, want)
