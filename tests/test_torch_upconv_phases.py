"""
The port's `upsample_conv_2d` (the `Conv0_up` layers), whose transposed conv
runs as one stride-1 conv per output phase, on the CPU against three
references: JAX's `upsample_conv_2d` (values and, through `jax.vjp`, the
gradients with respect to x and w), and `F.conv_transpose2d` written out here
(the form the phases replace). Inputs come from a seeded numpy RandomState;
the port works in NCHW/OIHW and JAX in NHWC/HWIO. Odd and even, non-square
sizes, Cin != Cout and random (non-symmetric) weights catch a phase taken
from the wrong taps, offset by a sample or written to the wrong slice.
Kernel C's phase-plane form (`blur4_separable_pad11_phases`, which blurs the
four phases where they lie), the route of an fp32 config-f `Conv0_up`, is
held by a numpy emulation of its CUDA index map against its twin.
"""

import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from gance_tpu_torch.ops import modulated_conv as port_mc  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402
from gance_tpu_torch.ops import upfirdn2d as port_up  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

# gance_tpu.ops re-exports the function upfirdn2d under the module's name
jax_up = importlib.import_module("gance_tpu.ops.upfirdn2d")

# (factor, conv size, FIR): config-f's (2, 3) with (1, 3, 3, 1) takes kernel C's
# blur; every other case takes the plain upfirdn2d, (1, 2, 1) a 3-tap FIR
CASES = [
    (2, 3, (1, 3, 3, 1)),
    (2, 1, (1, 3, 3, 1)),
    (2, 4, (1, 3, 3, 1)),
    (3, 3, (1, 3, 3, 1)),
    (2, 3, (1, 2, 1)),
]
SHAPES = [(2, 5, 4, 3, 6), (1, 4, 7, 5, 2)]  # (B, H, W, Cin, Cout): odd, even, non-square
# tests/test_torch_ops.py::test_upsample_conv_2d_matches_numpy_and_jax's bounds
RTOL = ATOL = 1e-4
TRANSPOSED_REL = 1e-5  # of max |ref|: the same fp32 products, summed in another order
# tests/test_torch_ops.py::test_modulated_conv2d_bf16_compute_dtype's bound for bf16 compute
BF16_TOL = 0.05


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def draw(seed: int, shape: tuple, ck: int):
    rng = np.random.RandomState(seed)
    b, h, w, cin, cout = shape
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (0.5 * rng.randn(ck, ck, cin, cout)).astype(np.float32)
    return rng, x, wt


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("factor,ck,fir", CASES)
def test_upsample_conv_2d_phases_match_jax(shape, factor, ck, fir):
    _, x, w = draw(0, shape, ck)
    got = port_up.upsample_conv_2d(nchw(x), oihw(w), fir, factor=factor)
    want = np.asarray(jax_up.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w), fir, factor=factor))
    assert nhwc(got).shape == want.shape
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("factor,ck", sorted({(f, k) for f, k, _ in CASES}))
def test_transposed_conv_phases_match_conv_transpose2d(shape, factor, ck):
    """The phases against the transposed conv they replace: PyTorch's
    `conv_transpose2d` flips its kernel and wants (Cin, Cout, kh, kw), so it
    gets w flipped and io-swapped (the two flips cancel)."""
    _, x, w = draw(1, shape, ck)
    xt, wt = nchw(x), oihw(w)
    want = F.conv_transpose2d(xt, wt.flip(2, 3).transpose(0, 1), stride=factor)
    got = port_up.transposed_conv_phases(xt, wt, factor)
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= TRANSPOSED_REL * float(want.abs().max()), err


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("factor,ck,fir", CASES)
def test_upsample_conv_2d_phase_gradients_match_jax(shape, factor, ck, fir):
    """d/dx and d/dw of <upsample_conv_2d(x, w), g> against jax.vjp of JAX's
    function with the same cotangent g. The gradients come from the port's
    own backward, not from autograd through the phases: for (2, 3) with the
    4-tap FIR, `_PhasedUpconvBlur.backward` (kernel C's input gradient, then
    the transposed conv's `convolution_backward`); for the other cases,
    `_PhasedTransposedConv.backward` (that `convolution_backward`) after
    upfirdn2d's autograd."""
    rng, x, w = draw(2, shape, ck)
    out, vjp = jax.vjp(lambda a, b: jax_up.upsample_conv_2d(a, b, fir, factor=factor),
                       jnp.asarray(x), jnp.asarray(w))
    g = rng.randn(*out.shape).astype(np.float32)
    want_x, want_w = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt, wt = nchw(x).requires_grad_(True), oihw(w).requires_grad_(True)
    y = port_up.upsample_conv_2d(xt, wt, fir, factor=factor)
    (y * nchw(g)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), want_x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), want_w, rtol=RTOL,
                               atol=ATOL)


def test_upsample_conv_2d_phases_bf16_match_jax_bf16():
    """bf16 x and w against JAX's bf16 conv. bf16 does not take the phases:
    `upsample_conv_2d` keeps `F.conv_transpose2d` for it (it repeats itself in
    bf16), then kernel C's twin."""
    _, x, w = draw(3, SHAPES[0], 3)
    got = port_up.upsample_conv_2d(nchw(x).to(torch.bfloat16), oihw(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jax_up.upsample_conv_2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


def emulate_blur4_phases(phases, taps) -> np.ndarray:
    """csrc/blur4_phases.cu's index map in numpy fp32, one output row pair m
    at a time as a thread walks its strip: the five windows of y rows 2m-1 ..
    2m+3 at y columns 2n-1 .. 2n+3 (zeros outside y), vertical then
    horizontal sums, taps left to right."""
    p00, p01, p10, p11 = (p.reshape((-1,) + p.shape[2:]) for p in phases)
    t = [np.float32(v) for v in taps]
    planes, h1, w1 = p00.shape
    h, w = h1 - 1, w1 - 1

    def window(even, odd, m, rows):
        v = np.zeros((5, planes, w), np.float32)
        if 0 <= m < rows:
            v[0, :, 1:] = odd[:, m, :w - 1]
            v[1], v[2], v[3] = even[:, m, :w], odd[:, m, :w], even[:, m, 1:]
            v[4, :, :w - 1] = odd[:, m, 1:]
        return v

    def sum4(a, b, c, d):
        return t[0] * a + t[1] * b + t[2] * c + t[3] * d

    out = np.zeros((planes, 2 * h, 2 * w), np.float32)
    for m in range(h):
        y = [window(p10, p11, m - 1, h), window(p00, p01, m, h + 1), window(p10, p11, m, h),
             window(p00, p01, m + 1, h + 1), window(p10, p11, m + 1, h)]
        for r, v in ((2 * m, sum4(*y[:4])), (2 * m + 1, sum4(*y[1:]))):
            out[:, r, 0::2], out[:, r, 1::2] = sum4(*v[:4]), sum4(*v[1:])
    return out.reshape(phases[0].shape[:2] + (2 * h, 2 * w))


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 5, 4), (1, 2, 8, 33), (2, 1, 17, 2)])
def test_blur4_phases_index_map_matches_twin(shape):
    """Kernel C's phase-plane form: the numpy emulation of its index map
    equals its twin (C's twin on the interleaved phases) bit for bit, and the
    wrapper takes the twin on CPU tensors."""
    b, c, h, w = shape
    rng = np.random.RandomState(5)
    phases = [rng.randn(b, c, h + 1 - i, w + 1 - j).astype(np.float32)
              for i in (0, 1) for j in (0, 1)]
    tensors = [torch.from_numpy(p) for p in phases]
    for taps in ((0.25, 0.75, 0.75, 0.25), (0.2, 0.4, 0.6, 0.8)):
        want = K.blur4_separable_pad11_phases_plain(tensors, taps)
        assert want.shape == (b, c, 2 * h, 2 * w)
        np.testing.assert_array_equal(emulate_blur4_phases(phases, taps), want.numpy())
        assert torch.equal(K.blur4_separable_pad11_phases(tensors, taps), want)


def test_blur4_phases_refuses_what_it_does_not_take():
    """Shapes that are not the four phases of a 3x3 stride-2 transposed conv,
    and inputs that would want a gradient of the phase form itself."""
    p = [torch.zeros((1, 2, 5 - i, 4 - j)) for i in (0, 1) for j in (0, 1)]
    with pytest.raises(ValueError):
        K.blur4_separable_pad11_phases(p[:3] + [torch.zeros((1, 2, 4, 4))], (1, 3, 3, 1))
    p[0].requires_grad_(True)
    with pytest.raises(RuntimeError):
        K.blur4_separable_pad11_phases(p, (1, 3, 3, 1))


def test_conv0_up_runs_no_transposed_conv(monkeypatch):
    """A modulated `Conv0_up` (up=True) reaches no `conv_transpose2d`."""

    def refuse(*args, **kwargs):
        raise AssertionError("conv_transpose2d called on the Conv0_up path")

    monkeypatch.setattr(F, "conv_transpose2d", refuse)
    monkeypatch.setattr(torch, "conv_transpose2d", refuse)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 4, 5, 6).astype(np.float32))
    y = port_mc.modulated_conv2d(
        x, torch.from_numpy(rng.randn(2, 8).astype(np.float32)),
        torch.from_numpy(rng.randn(3, 4, 3, 3).astype(np.float32)),
        torch.from_numpy(rng.randn(8, 4).astype(np.float32)), torch.zeros(4), up=True)
    assert y.shape == (2, 3, 10, 12) and bool(torch.isfinite(y).all())
