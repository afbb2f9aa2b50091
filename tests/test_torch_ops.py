"""
Parity of the PyTorch port's ops (gance_tpu_torch.ops) with the JAX ops and
with the numpy references, on the CPU. Inputs come from a seeded numpy
RandomState; the port works in NCHW/OIHW and the JAX ops in NHWC/HWIO, so
tensors are transposed at the boundary. Tolerances are fp32 ones: the two
frameworks sum in different orders.
"""

import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.ops.bias_act import bias_act as jax_bias_act_fn  # noqa: E402
from gance_tpu.ops import modulated_conv as jax_mc  # noqa: E402
from gance_tpu_torch.ops.bias_act import bias_act as port_bias_act_fn  # noqa: E402
from gance_tpu_torch.ops import modulated_conv as port_mc  # noqa: E402
from gance_tpu_torch.ops import precision  # noqa: E402
from gance_tpu_torch.ops import upfirdn2d as port_up  # noqa: E402
from tests import numpy_reference as ref  # noqa: E402

# gance_tpu.ops re-exports the function upfirdn2d under the module's name
jax_up = importlib.import_module("gance_tpu.ops.upfirdn2d")

# fp32, sums of a few hundred terms taken in another order
ATOL = 1e-5
RTOL = 1e-5


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("act", ["linear", "lrelu", "relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("rank", [2, 4])
def test_bias_act_matches_jax(rng, act, rank):
    shape = (3, 5) if rank == 2 else (2, 4, 4, 5)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(jax_bias_act_fn(jnp.asarray(x), jnp.asarray(b), act=act))
    xt = torch.from_numpy(x) if rank == 2 else nchw(x)
    got = port_bias_act_fn(xt, torch.from_numpy(b), act=act)
    got = got.numpy() if rank == 2 else nhwc(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bias_act_rejects_unknown_activation():
    with pytest.raises(ValueError, match="Unknown activation"):
        port_bias_act_fn(torch.zeros(2, 2), act="gelu")


def test_setup_filter_kernel_matches_jax():
    for kernel, gain in [((1, 3, 3, 1), 1.0), ((1, 3, 3, 1), 4.0), ((1, 2, 1), 2.0)]:
        np.testing.assert_array_equal(
            port_up.setup_filter_kernel(kernel, gain), jax_up.setup_filter_kernel(kernel, gain)
        )


@pytest.mark.parametrize(
    "up,down,pad0,pad1",
    [(1, 1, 0, 0), (2, 1, 2, 1), (1, 2, 1, 1), (1, 1, 1, 1), (2, 1, -1, 0), (1, 1, 2, -1)],
)
def test_upfirdn2d_matches_numpy_and_jax(rng, up, down, pad0, pad1):
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    k = port_up.setup_filter_kernel(rng.rand(4).astype(np.float32) + 0.1)
    k = k + 0.05 * rng.rand(4, 4).astype(np.float32)  # non-separable, non-symmetric
    want = ref.upfirdn2d_np(x, k.astype(np.float64), up=up, down=down, pad0=pad0, pad1=pad1)
    got = nhwc(port_up.upfirdn2d(nchw(x), k, up=up, down=down, pad0=pad0, pad1=pad1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jax_out = np.asarray(jax_up.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad0=pad0, pad1=pad1))
    np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 4, 4, 3), (2, 8, 6, 3), (1, 5, 5, 16)])
def test_upsample_2d_matches_jax_and_numpy(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    got = nhwc(port_up.upsample_2d_nchw(nchw(x)))
    np.testing.assert_allclose(got, ref.upsample_2d_np(x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_up.upsample_2d(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    want_nchw = np.asarray(jax_up.upsample_2d_nchw(jnp.asarray(nchw(x).numpy())))
    np.testing.assert_allclose(port_up.upsample_2d(nchw(x)).numpy(), want_nchw,
                               rtol=RTOL, atol=ATOL)


def test_upsample_2d_other_fir_takes_upfirdn2d(rng):
    """A FIR other than [1,3,3,1] and a factor other than 2 use the plain upfirdn2d."""
    x = rng.randn(1, 5, 5, 2).astype(np.float32)
    for kernel, factor in [((1, 2, 1), 2), ((1, 3, 3, 1), 3)]:
        got = nhwc(port_up.upsample_2d(nchw(x), kernel, factor=factor))
        want = ref.upsample_2d_np(x, kernel, factor=factor)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,cout", [((2, 4, 4, 5), 6), ((1, 6, 5, 3), 4)])
def test_upsample_conv_2d_matches_numpy_and_jax(rng, shape, cout):
    """Random non-symmetric weights catch a wrongly flipped or io-swapped kernel."""
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(3, 3, shape[-1], cout).astype(np.float32)
    got = port_up.upsample_conv_2d(nchw(x), oihw(w))
    assert got.shape == (shape[0], cout, 2 * shape[1], 2 * shape[2])
    got = nhwc(got)
    np.testing.assert_allclose(got, ref.upsample_conv_2d_np(x, w), rtol=1e-4, atol=1e-4)
    want = np.asarray(jax_up.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("resample_kernel", [(1, 3, 3, 1), (1, 2, 3, 4), (1, 1, 1, 1)])
def test_separable_fir_orientation_matches_jax(rng, resample_kernel):
    """A separable 4-tap FIR that is not symmetric is a true convolution in JAX:
    kernel C's correlation gets the root reversed, and kernel B the polyphase
    taps in JAX's order. Without that repair the (1, 2, 3, 4) case fails both
    checks by more than 1."""
    x = rng.randn(2, 6, 5, 3).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 3, 4)).astype(np.float32)
    got = nhwc(port_up.upsample_conv_2d(nchw(x), oihw(w), resample_kernel))
    want = np.asarray(jax_up.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w), resample_kernel))
    assert float(np.abs(got - want).max()) <= 1e-5
    xc = nchw(x)
    got = port_up.upsample_2d_nchw(xc, resample_kernel).numpy()
    want = np.asarray(jax_up.upsample_2d_nchw(jnp.asarray(xc.numpy()), resample_kernel))
    assert float(np.abs(got - want).max()) <= 1e-5


def _analysis_today(kernel, factor, gain, ck, kind):
    """The per-call tap analysis of the resample functions as written before
    their plans were kept, from the same helpers: the branch and its taps."""
    if kind == "up":
        k = port_up.setup_filter_kernel(kernel, gain * factor ** 2)
        if factor == 2 and port_up._separable_4tap(k):
            return "B", tuple(float(v) for v in port_up._separable_root(k))
        p = k.shape[0] - factor
        return "upfirdn2d", k, (p + 1) // 2 + factor - 1, p // 2
    if kind == "up_conv":
        k = port_up.setup_filter_kernel(kernel, gain * factor ** 2)
        p = (k.shape[0] - factor) - (ck - 1)
        pad0, pad1 = (p + 1) // 2 + factor - 1, p // 2 + 1
        if pad0 == 1 and pad1 == 1 and port_up._separable_4tap(k):
            return "C", tuple(float(v) for v in port_up._separable_root(k)[::-1])
        return "upfirdn2d", k, pad0, pad1
    k = port_up.setup_filter_kernel(kernel, gain)
    p = (k.shape[0] - factor) + (ck - 1)
    pad0, pad1 = (p + 1) // 2, p // 2
    if k.shape == (4, 4) and 0 <= pad0 <= 3 and 0 <= pad1 <= 3:
        return "D", k[::-1, ::-1], pad0, pad1
    return "upfirdn2d", k, pad0, pad1


RESAMPLE_FIRS = {
    "binomial": (1, 3, 3, 1),
    "1234": (1, 2, 3, 4),
    "non-separable 4x4": ((1.0, 2.0, 0.0, 1.0), (0.5, 1.0, 3.0, 1.0), (2.0, 0.0, 1.0, 1.0),
                          (1.0, 1.0, 1.0, 4.0)),
    "1-D numpy": np.array([1.0, 3.0, 3.0, 1.0], np.float32),
    "2-D numpy": np.outer((1, 2, 3, 4), (4, 3, 2, 1)).astype(np.float64),
}


def _record_resample_kernels(m, seen):
    """Wrap the four forms a resample call may take to record their arguments."""
    for name in ("upsample2x_blur", "blur4_separable_pad11", "stencil_blur4_valid", "upfirdn2d"):
        real = getattr(port_up, name)
        m.setattr(port_up, name, lambda *a, _n=name, _r=real, **kw: (
            seen.append((_n, a[1:], kw)), _r(*a, **kw))[1])


@pytest.mark.parametrize("fir", sorted(RESAMPLE_FIRS))
def test_resample_plans_equal_the_per_call_analysis(rng, fir, monkeypatch):
    """Each resample function's kept plan takes today's branch (B, C, D or
    the plain upfirdn2d) with today's taps, FIR and pads, on its first call
    and again from the cache, with the FIR as a tuple, a nested tuple or a
    numpy array; the second call runs no analysis."""
    kernel = RESAMPLE_FIRS[fir]
    kernel_of = {"B": "upsample2x_blur", "C": "blur4_separable_pad11", "D": "stencil_blur4_valid",
                 "upfirdn2d": "upfirdn2d"}
    monkeypatch.setattr(port_up, "_PLANS", {})
    x = torch.from_numpy(rng.randn(1, 2, 6, 6).astype(np.float32))
    w3 = torch.from_numpy(rng.randn(2, 2, 3, 3).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(2, 2, 1, 1).astype(np.float32))
    calls = [("up", 2, 1.0, None, lambda: port_up.upsample_2d(x, kernel)),
             ("up", 2, 2.0, None, lambda: port_up.upsample_2d(x, kernel, gain=2.0)),
             ("up_conv", 2, 1.0, 3, lambda: port_up.upsample_conv_2d(x, w3, kernel)),
             ("down", 2, 1.0, 1, lambda: port_up.downsample_2d(x, kernel)),
             ("down", 2, 1.0, 3, lambda: port_up.conv_downsample_2d(x, w3, kernel)),
             ("down", 2, 1.0, 1, lambda: port_up.conv_downsample_2d(x, w1, kernel))]
    for kind, factor, gain, ck, call in calls:
        want = _analysis_today(kernel, factor, gain, ck, kind)
        outs = []
        for cached in (False, True):
            seen = []
            with monkeypatch.context() as m:
                _record_resample_kernels(m, seen)
                if cached:
                    m.setattr(port_up, "setup_filter_kernel", None)  # no analysis now
                outs.append(call())
            name, args, kw = seen[0]
            assert name == kernel_of[want[0]], (kind, name)
            if want[0] == "upfirdn2d":
                assert np.array_equal(args[0], want[1])
                assert (kw["pad0"], kw["pad1"]) == want[2:], (kind, kw)
            elif want[0] == "D":
                assert np.array_equal(np.reshape(args[0], (4, 4)), want[1]) and args[1] == want[2:]
            else:
                assert args[0] == want[1]
        assert torch.equal(outs[0], outs[1])


def test_style_and_demod_vectors_match_jax(rng):
    style_w = rng.randn(3, 16).astype(np.float32)
    mod_w = rng.randn(16, 8).astype(np.float32)
    mod_b = rng.randn(8).astype(np.float32)
    w = rng.randn(3, 3, 8, 5).astype(np.float32) * 0.2
    s_want = np.asarray(jax_mc.style_vector(jnp.asarray(style_w), jnp.asarray(mod_w), jnp.asarray(mod_b)))
    s_got = port_mc.style_vector(torch.from_numpy(style_w), torch.from_numpy(mod_w), torch.from_numpy(mod_b))
    np.testing.assert_allclose(s_got.numpy(), s_want, rtol=RTOL, atol=ATOL)
    d_want = np.asarray(jax_mc.demod_vector(jnp.asarray(s_want), jnp.asarray(w)))
    d_got = port_mc.demod_vector(torch.from_numpy(s_want.copy()), oihw(w))
    np.testing.assert_allclose(d_got.numpy(), d_want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("up,demodulate,kernel", [
    (False, True, 3), (False, False, 1), (True, True, 3), (False, True, 1),
])
def test_modulated_conv2d_matches_jax_and_numpy(rng, up, demodulate, kernel):
    b, h, cin, cout, wdim = 2, 5, 6, 4, 8
    x = rng.randn(b, h, h, cin).astype(np.float32)
    style_w = rng.randn(b, wdim).astype(np.float32)
    weight = rng.randn(kernel, kernel, cin, cout).astype(np.float32)
    mod_w = rng.randn(wdim, cin).astype(np.float32)
    mod_b = rng.randn(cin).astype(np.float32) * 0.1
    want = np.asarray(jax_mc.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(style_w), jnp.asarray(weight), jnp.asarray(mod_w),
        jnp.asarray(mod_b), up=up, demodulate=demodulate,
    ))
    got = nhwc(port_mc.modulated_conv2d(
        nchw(x), torch.from_numpy(style_w), oihw(weight), torch.from_numpy(mod_w),
        torch.from_numpy(mod_b), up=up, demodulate=demodulate,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    literal = ref.modulated_conv2d_np(x, style_w, weight, mod_w, mod_b, up=up, demodulate=demodulate)
    np.testing.assert_allclose(got, literal, rtol=1e-4, atol=1e-4)


def test_modulated_conv2d_bf16_compute_dtype(rng):
    """bf16 compute: output in bf16, close to fp32 at bf16's 8 mantissa bits."""
    x = rng.randn(1, 6, 6, 8).astype(np.float32)
    args = (torch.from_numpy(rng.randn(1, 8).astype(np.float32)),
            oihw(rng.randn(3, 3, 8, 8).astype(np.float32)),
            torch.from_numpy(rng.randn(8, 8).astype(np.float32)),
            torch.zeros(8))
    f32 = port_mc.modulated_conv2d(nchw(x), *args)
    bf16 = port_mc.modulated_conv2d(nchw(x), *args, compute_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("lrmul,with_bias", [(1.0, False), (0.01, True)])
def test_dense_layer_matches_jax(rng, lrmul, with_bias):
    x = rng.randn(3, 12).astype(np.float32)
    w = rng.randn(12, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32) if with_bias else None
    want = np.asarray(jax_mc.dense_layer(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), lrmul=lrmul))
    got = port_mc.dense_layer(
        torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        lrmul=lrmul)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert port_mc.runtime_weight_coef(12, lrmul=lrmul) == jax_mc.runtime_weight_coef(12, lrmul=lrmul)


def test_precision_policy_turns_tf32_off_and_restores():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        precision.apply_conv_precision()
        expect = precision.CONV_PRECISION != "highest"
        assert torch.backends.cudnn.allow_tf32 is expect
        assert torch.backends.cuda.matmul.allow_tf32 is expect
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with precision.exact_fp32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
