"""
The port's kernels A-D (gance_tpu_torch/ops/cuda) on the CPU: each kernel's
plain PyTorch twin against the Pallas function it replaces, run in interpret
mode, at the shapes of tests/test_pallas_ops.py plus a C=64 case with an odd
w_logical (the 1024px top block); B at a FIR that is not symmetric against
JAX's polyphase form; D at the binomial and the (1, 2, 3, 4) FIR and at its
implicit pads; the gradients of the autograd Functions of A-D, first and
second order, against autograd through the twins and against jax.grad of the
JAX operation each kernel replaces (the Pallas kernels have no autodiff rule;
their XLA formulations do); E's refusal under grad; the wrappers' CPU
dispatch and input checks; and the ctypes binding of all five kernels
against the C signatures in csrc/. Kernel E's twin is held against its
Pallas kernel in tests/test_torch_phase_block.py. The kernels themselves run
only on a GPU: tests/test_torch_kernels_gpu.py holds each against its twin
there, and `python3 chip_smoke.py` does so at the 1024px shapes.
"""

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.ops.bias_act import bias_act as jax_bias_act  # noqa: E402
from gance_tpu.ops.pallas import fused_ops as pallas  # noqa: E402
from gance_tpu.ops.upfirdn2d import setup_filter_kernel, upfirdn2d, upsample2x_polyphase_nchw  # noqa: E402
from gance_tpu_torch.ops.cuda import build  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402

TAPS = (0.25, 0.75, 0.75, 0.25)
TAPS_1234 = (0.2, 0.4, 0.6, 0.8)  # the root of the non-symmetric FIR (1, 2, 3, 4)
FIR_1234 = np.outer((1, 2, 3, 4), (1, 2, 3, 4)) / 100.0  # a 4x4 FIR that is not symmetric
# fp32: the twins and the Pallas kernels add the same terms, in a different
# association at most
TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 16, 8, 4), (2, 4, 4, 64)])
def test_fused_bias_noise_lrelu_twin_matches_pallas(rng, shape):
    b, h, w, c = shape
    x = rng.randn(*shape).astype(np.float32)
    noise = rng.randn(1, h, w, 1).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    strength = np.float32(0.37)
    want = np.asarray(pallas.fused_bias_noise_lrelu(
        jnp.asarray(x), jnp.asarray(noise), jnp.asarray(bias), jnp.asarray(strength),
        interpret=True,
    ))
    got = K.fused_bias_noise_lrelu_plain(
        nchw(x), nchw(noise), torch.from_numpy(bias), torch.tensor(strength))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_fused_bias_noise_lrelu_per_sample_noise(rng):
    """(B, 1, H, W) noise (noise_mode='random') adds each sample's own plane."""
    x = torch.from_numpy(rng.randn(3, 2, 4, 4).astype(np.float32))
    noise = torch.from_numpy(rng.randn(3, 1, 4, 4).astype(np.float32))
    bias, strength = torch.zeros(2), torch.tensor(0.5)
    got = K.fused_bias_noise_lrelu(x, noise, bias, strength)
    for i in range(3):
        want = K.fused_bias_noise_lrelu(x[i:i + 1], noise[i:i + 1], bias, strength)
        torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 8, 8, 3), (2, 16, 8, 4), (1, 4, 4, 1)])
def test_upsample2x_blur_twin_matches_pallas(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(pallas.upsample2x_blur(jnp.asarray(x), interpret=True))
    got = K.upsample2x_blur_plain(nchw(x), TAPS)
    assert got.shape == (shape[0], shape[3], 2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(nhwc(got), want, **TOL)
    polyphase = np.asarray(upsample2x_polyphase_nchw(jnp.asarray(nchw(x).numpy()), TAPS))
    np.testing.assert_allclose(got.numpy(), polyphase, **TOL)


def test_upsample2x_blur_twin_takes_non_symmetric_taps(rng):
    """B's taps are the polyphase taps in JAX's order: even phase k0*x[i-1] +
    k2*x[i], odd phase k1*x[i] + k3*x[i+1], for a root that is not symmetric."""
    root = (0.2, 0.4, 0.6, 0.8)  # (1, 2, 3, 4) with gain 2 per axis
    x = rng.randn(2, 3, 7, 5).astype(np.float32)
    want = np.asarray(upsample2x_polyphase_nchw(jnp.asarray(x), root))
    got = K.upsample2x_blur_plain(torch.from_numpy(x), root)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    reversed_root = K.upsample2x_blur_plain(torch.from_numpy(x), root[::-1])
    assert float((reversed_root - got).abs().max()) > 0.1


@pytest.mark.parametrize(
    "shape,w_logical",
    [
        ((2, 65, 65, 8), None),
        ((1, 129, 136, 16), 129),
        ((2, 33, 40, 8), 33),
        ((1, 33, 33, 64), None),
        ((1, 17, 32, 64), 17),
    ],
)
def test_blur4_separable_pad11_twin_matches_pallas(rng, shape, w_logical):
    x = rng.randn(*shape).astype(np.float32)
    wl = w_logical or shape[2]
    want = np.asarray(pallas.blur4_separable_pad11(
        jnp.asarray(x), TAPS, w_logical=w_logical, interpret=True))
    xt = nchw(x)
    if w_logical is not None:
        xt[..., wl:] = float("nan")  # junk columns are never read
    got = K.blur4_separable_pad11_plain(xt, TAPS, w_logical)
    assert got.shape == (shape[0], shape[3], shape[1] - 1, wl - 1)
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_use_the_twins_on_cpu(rng, dtype):
    """On a CPU tensor each wrapper returns its twin's result and launches nothing."""
    x = torch.from_numpy(rng.randn(2, 4, 9, 9).astype(np.float32)).to(dtype)
    noise = torch.from_numpy(rng.randn(1, 1, 9, 9).astype(np.float32))
    bias, strength = torch.from_numpy(rng.randn(4).astype(np.float32)), torch.tensor(0.2)
    before = dict(K.LAUNCHES)
    pairs = [
        (K.fused_bias_noise_lrelu(x, noise, bias, strength),
         K.fused_bias_noise_lrelu_plain(x, noise, bias, strength)),
        (K.upsample2x_blur(x, TAPS), K.upsample2x_blur_plain(x, TAPS)),
        (K.blur4_separable_pad11(x, TAPS, 7), K.blur4_separable_pad11_plain(x, TAPS, 7)),
        (K.stencil_blur4_valid(x, FIR_1234, (2, 1)),
         K.stencil_blur4_valid_plain(x, FIR_1234, (2, 1))),
    ]
    for got, want in pairs:
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert K.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        K.fused_bias_noise_lrelu(x, torch.zeros(1, 1, 4, 5), torch.zeros(2), torch.tensor(1.0))
    with pytest.raises(ValueError, match="bad shapes"):
        K.fused_bias_noise_lrelu(x, torch.zeros(1, 1, 4, 4), torch.zeros(3), torch.tensor(1.0))
    with pytest.raises(ValueError, match="one value"):
        K.fused_bias_noise_lrelu(x, torch.zeros(1, 1, 4, 4), torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="NCHW"):
        K.upsample2x_blur(torch.zeros(2, 4, 4), TAPS)
    with pytest.raises(ValueError, match="w_logical"):
        K.blur4_separable_pad11(x, TAPS, w_logical=5)
    with pytest.raises(ValueError, match="4 taps"):
        K.blur4_separable_pad11(x, (0.5, 0.5))
    with pytest.raises(ValueError, match="4 taps"):
        K.upsample2x_blur(x, (0.5, 1.0, 0.5))
    with pytest.raises(ValueError, match="unsupported device"):
        K.upsample2x_blur(torch.zeros(1, 1, 2, 2, device="meta"), TAPS)
    with pytest.raises(ValueError, match="4x4 FIR"):
        K.stencil_blur4_valid(x, np.ones((3, 3)))
    with pytest.raises(ValueError, match=r"\[0, 3\]"):
        K.stencil_blur4_valid(x, FIR_1234, (4, 0))
    with pytest.raises(ValueError, match="smaller than the FIR"):
        K.stencil_blur4_valid(torch.zeros(1, 2, 2, 6), FIR_1234, (0, 1))


def _c_signatures():
    """{C function name: parameter count} from the extern "C" definitions in csrc/."""
    found = {}
    for path in build.CSRC.glob("*.cu"):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = (path.stem, len([p for p in params.split(",") if p.strip()]))
    return found


def test_ctypes_bindings_match_c_signatures():
    """Every bound function exists in its source with as many parameters as argtypes
    (the wrapper appends the stream), and every source is built for sm_90a."""
    signatures = _c_signatures()
    assert len(signatures) == len(build.FUNCTIONS) == 5
    for stem, (symbol, argtypes) in build.FUNCTIONS.items():
        assert signatures[symbol] == (stem, len(argtypes))
        assert (build.CSRC / f"{stem}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--fmad=false" in build.NVCC_FLAGS


def test_library_paths_key_on_the_sources():
    paths = {build.library_path(name) for name in build.FUNCTIONS}
    assert len(paths) == 5
    for path in paths:
        assert path.parent == build.BUILD_DIR
        assert re.fullmatch(r"\w+-[0-9a-f]{16}\.so", path.name)


# ---------------------------------------------------------------------------
# D. stencil_blur4_valid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fir", [(1, 3, 3, 1), (1, 2, 3, 4)])
@pytest.mark.parametrize("shape", [(2, 19, 19, 8), (1, 11, 27, 4)])
def test_stencil_blur4_valid_twin_matches_pallas(rng, shape, fir):
    """At tests/test_pallas_ops.py's shapes, with the taps pre-flipped as the
    Pallas kernel takes them, and against JAX's upfirdn2d (a true convolution)."""
    x = rng.randn(*shape).astype(np.float32)
    k = setup_filter_kernel(fir, gain=4.0)
    kflip = tuple(tuple(float(v) for v in row) for row in k[::-1, ::-1])
    want = np.asarray(pallas.stencil_blur4_valid(jnp.asarray(x), kflip, interpret=True))
    got = K.stencil_blur4_valid_plain(nchw(x), kflip)
    assert got.shape == (shape[0], shape[3], shape[1] - 3, shape[2] - 3)
    np.testing.assert_allclose(nhwc(got), want, **TOL)
    xla = np.asarray(upfirdn2d(jnp.asarray(x), k))
    np.testing.assert_allclose(nhwc(got), xla, **TOL)


@pytest.mark.parametrize("pads", [(0, 0), (2, 2), (1, 1), (3, 0), (0, 3), (1, 2)])
def test_stencil_blur4_valid_implicit_pad_matches_padded_pallas(rng, pads):
    """The implicit pad equals the Pallas kernel run on an explicitly padded input."""
    p0, p1 = pads
    x = rng.randn(2, 9, 13, 3).astype(np.float32)
    k = FIR_1234 + rng.randn(4, 4) * 0.01  # a general, non-separable 4x4
    xp = np.pad(x, ((0, 0), (p0, p1), (p0, p1), (0, 0)))
    taps = tuple(tuple(float(v) for v in row) for row in k.astype(np.float32))
    want = np.asarray(pallas.stencil_blur4_valid(jnp.asarray(xp), taps, interpret=True))
    got = K.stencil_blur4_valid(nchw(x), k, pads)
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_stencil_blur4_valid_bf16_sums_in_fp32(rng):
    x = torch.from_numpy(rng.randn(1, 2, 8, 8).astype(np.float32)).to(torch.bfloat16)
    got = K.stencil_blur4_valid(x, FIR_1234, (2, 2))
    want = K.stencil_blur4_valid_plain(x.float(), FIR_1234, (2, 2)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Gradients through the Functions of A-D
# ---------------------------------------------------------------------------


def _a_inputs(rng, noise_batch):
    return [rng.randn(2, 3, 6, 7).astype(np.float32), rng.randn(noise_batch, 1, 6, 7).astype(np.float32),
            rng.randn(3).astype(np.float32), np.float32(0.37)]


# name -> (port function of NCHW tensors, JAX function of NCHW arrays, inputs)
def _cases(rng):
    def jax_a(x, n, b, s):
        pre = x + n * s
        return jnp.transpose(jax_bias_act(jnp.transpose(pre, (0, 2, 3, 1)), b, act="lrelu"),
                             (0, 3, 1, 2))

    def jax_fir(x, k, p0, p1, w_logical=None):
        x = x if w_logical is None else x[..., :w_logical]
        out = upfirdn2d(jnp.transpose(x, (0, 2, 3, 1)), k, pad0=p0, pad1=p1)
        return jnp.transpose(out, (0, 3, 1, 2))

    k_c = np.outer(TAPS_1234[::-1], TAPS_1234[::-1])  # C correlates with TAPS_1234
    return {
        "A": (K.fused_bias_noise_lrelu, jax_a, _a_inputs(rng, 2)),
        "A_shared_noise": (K.fused_bias_noise_lrelu, jax_a, _a_inputs(rng, 1)),
        "B": (lambda x: K.upsample2x_blur(x, TAPS_1234),
              lambda x: upsample2x_polyphase_nchw(x, TAPS_1234),
              [rng.randn(2, 3, 5, 6).astype(np.float32)]),
        "C": (lambda x: K.blur4_separable_pad11(x, TAPS_1234, 9),
              lambda x: jax_fir(x, k_c, 1, 1, 9),
              [rng.randn(2, 3, 9, 12).astype(np.float32)]),
        "D_pad22": (lambda x: K.stencil_blur4_valid(x, FIR_1234, (2, 2)),
                    lambda x: jax_fir(x, FIR_1234[::-1, ::-1], 2, 2),
                    [rng.randn(2, 3, 9, 10).astype(np.float32)]),
        "D_pad10": (lambda x: K.stencil_blur4_valid(x, FIR_1234, (1, 0)),
                    lambda x: jax_fir(x, FIR_1234[::-1, ::-1], 1, 0),
                    [rng.randn(2, 3, 9, 10).astype(np.float32)]),
    }


def _twin_of(name):
    return {
        "A": K.fused_bias_noise_lrelu_plain,
        "A_shared_noise": K.fused_bias_noise_lrelu_plain,
        "B": lambda x: K.upsample2x_blur_plain(x, TAPS_1234),
        "C": lambda x: K.blur4_separable_pad11_plain(x, TAPS_1234, 9),
        "D_pad22": lambda x: K.stencil_blur4_valid_plain(x, FIR_1234, (2, 2)),
        "D_pad10": lambda x: K.stencil_blur4_valid_plain(x, FIR_1234, (1, 0)),
    }[name]


def _torch_grads(fn, inputs, w, u):
    """First order: d sum(f(x)^2 w) / d inputs; second order: d sum(first * u)
    / d inputs, through a graph of the first-order pass (create_graph)."""
    ts = [torch.tensor(v, requires_grad=True) for v in inputs]
    y = fn(*ts)
    first = torch.autograd.grad((y.square() * torch.from_numpy(w)).sum(), ts, create_graph=True)
    total = sum((g * torch.from_numpy(v)).sum() for g, v in zip(first, u))
    second = torch.autograd.grad(total, ts, allow_unused=True)
    second = [torch.zeros_like(t) if g is None else g for t, g in zip(ts, second)]
    return [g.detach().numpy() for g in first], [g.numpy() for g in second]


def _jax_grads(fn, inputs, w, u):
    def loss(*args):
        return jnp.sum(jnp.square(fn(*args)) * w)

    argnums = tuple(range(len(inputs)))
    first = jax.grad(loss, argnums=argnums)

    def probed(*args):
        return sum(jnp.sum(g * v) for g, v in zip(first(*args), u))

    args = [jnp.asarray(v) for v in inputs]
    return ([np.asarray(g) for g in first(*args)],
            [np.asarray(g) for g in jax.grad(probed, argnums=argnums)(*args)])


@pytest.mark.parametrize("name", ["A", "A_shared_noise", "B", "C", "D_pad22", "D_pad10"])
def test_function_gradients_match_twin_and_jax(rng, name):
    """First and second order gradients of every input through each Function
    against autograd through its twin (within 1e-5 of each gradient's scale)
    and against jax.grad of the JAX operation (within 1e-4 of the scale)."""
    port_fn, jax_fn, inputs = _cases(rng)[name]
    y = port_fn(*[torch.tensor(v) for v in inputs])
    w = rng.randn(*y.shape).astype(np.float32)
    u = [np.asarray(rng.randn(*np.shape(v)), np.float32) for v in inputs]
    got = _torch_grads(port_fn, inputs, w, u)
    twin = _torch_grads(_twin_of(name), inputs, w, u)
    ref = _jax_grads(jax_fn, inputs, w, u)
    for order in (0, 1):
        for g, t, r in zip(got[order], twin[order], ref[order]):
            scale = max(float(np.abs(r).max()), 1e-6)
            assert g.shape == r.shape
            np.testing.assert_allclose(g, t, rtol=0, atol=1e-5 * scale)
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * scale)


def test_c_input_gradient_runs_through_d(rng):
    """C's input gradient is kernel D over the output gradient padded (2, 2),
    with zero gradient on the columns past w_logical."""
    x = torch.tensor(rng.randn(1, 2, 9, 12).astype(np.float32), requires_grad=True)
    calls = []
    real = K._stencil_blur4_valid_run

    def spy(t, taps, pads):
        calls.append((tuple(t.shape), pads))
        return real(t, taps, pads)

    K._stencil_blur4_valid_run = spy
    try:
        y = K.blur4_separable_pad11(x, TAPS_1234, 9)
        (gx,) = torch.autograd.grad(y.sum(), x)
    finally:
        K._stencil_blur4_valid_run = real
    assert calls == [((1, 2, 8, 8), (2, 2))]
    assert float(gx[..., 9:].abs().max()) == 0.0 and float(gx[..., :9].abs().min()) > 0.0


def test_noncontiguous_output_gradient(rng):
    """A permuted output gradient (as synthesis' NHWC output gives) works."""
    x = torch.tensor(rng.randn(1, 3, 8, 8).astype(np.float32), requires_grad=True)
    y = K.stencil_blur4_valid(K.blur4_separable_pad11(x, TAPS, 8), FIR_1234, (1, 1))
    (gx,) = torch.autograd.grad((y.permute(0, 2, 3, 1) * 2.0).sum(), x)
    x2 = x.detach().clone().requires_grad_(True)
    y2 = K.stencil_blur4_valid_plain(K.blur4_separable_pad11_plain(x2, TAPS, 8), FIR_1234, (1, 1))
    (want,) = torch.autograd.grad((y2 * 2.0).sum(), x2)
    torch.testing.assert_close(gx, want, rtol=1e-5, atol=1e-5)


def test_phase_conv1_torgb_refuses_grad():
    """E has no backward: under grad it raises instead of cutting gradients."""
    x = torch.zeros(1, 4, 3, 3, requires_grad=True)
    args = (torch.zeros(4, 4, 2, 2), torch.ones(1, 4), torch.zeros(1, 4, 4, 4), torch.zeros(1, 4, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.phase_conv1_torgb(x, *args)
    with torch.no_grad():
        assert K.phase_conv1_torgb(x, *args).shape == (1, 16, 4, 4)
