"""
The port's kernels A-D (gance_tpu_torch/ops/cuda) on the CPU: each kernel's
plain PyTorch twin against the Pallas function it replaces, run in interpret
mode, at the shapes of tests/test_pallas_ops.py plus a C=64 case with an odd
w_logical (the 1024px top block); B at a FIR that is not symmetric against
JAX's polyphase form; D at the binomial and the (1, 2, 3, 4) FIR and at its
implicit pads; the gradients of the autograd Functions of A-D, first and
second order, against autograd through the twins and against jax.grad of the
JAX operation each kernel replaces (the Pallas kernels have no autodiff rule;
their XLA formulations do); E's first and second order gradients against
autograd through its dense twin; the wrappers' CPU
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


def _wrapper_calls(rng):
    """name -> (public wrapper, its Function, NCHW fp32 inputs) for A-E."""
    from gance_tpu_torch.ops.cuda import autograd as A

    v = rng.randn(3, 3, 3, 3).astype(np.float32) * 0.2
    e_inputs = [rng.randn(2, 12, 4, 5).astype(np.float32), K.fold_conv1_weights(
        torch.from_numpy(v)).numpy(), np.abs(rng.randn(2, 12)).astype(np.float32) + 0.5,
        rng.randn(1, 12, 5, 6).astype(np.float32) * 0.1,
        rng.randn(2, 12, 16).astype(np.float32) * 0.2]
    return {
        "A": (K.fused_bias_noise_lrelu, A.FusedBiasNoiseLrelu, _a_inputs(rng, 2)),
        "A_scaled": (K.fused_bias_noise_lrelu, A.FusedBiasNoiseLrelu,
                     _a_inputs(rng, 2) + [rng.rand(2, 3).astype(np.float32) + 0.5]),
        "B": (lambda x: K.upsample2x_blur(x, TAPS_1234), A.Upsample2xBlur,
              [rng.randn(2, 3, 5, 6).astype(np.float32)]),
        "C": (lambda x: K.blur4_separable_pad11(x, TAPS_1234, 9), A.Blur4SeparablePad11,
              [rng.randn(2, 3, 9, 12).astype(np.float32)]),
        "D": (lambda x: K.stencil_blur4_valid(x, FIR_1234, (2, 1)), A.StencilBlur4Valid,
              [rng.randn(2, 3, 9, 10).astype(np.float32)]),
        "E": (K.phase_conv1_torgb, A.PhaseConv1Torgb, e_inputs),
    }


@pytest.mark.parametrize("name", ["A", "A_scaled", "B", "C", "D", "E"])
def test_wrappers_skip_the_function_where_no_gradient_is_wanted(rng, name, monkeypatch):
    """Each public wrapper gives the same output with grad enabled and inputs
    that require it (through its autograd Function, whose node the output
    carries), with grad enabled and none that requires it, under
    `torch.no_grad` and under `torch.inference_mode` (the last three without
    the Function)."""
    fn, function, inputs = _wrapper_calls(rng)[name]
    with_grad = fn(*[torch.tensor(v, requires_grad=True) for v in inputs])
    assert type(with_grad.grad_fn).__name__ == function.__name__ + "Backward"
    plain = [torch.tensor(v) for v in inputs]

    def refuse(*args):
        raise AssertionError("the Function ran where no gradient is wanted")

    monkeypatch.setattr(function, "apply", refuse)
    outputs = [fn(*plain)]
    with torch.no_grad():
        outputs.append(fn(*plain))
    with torch.inference_mode():
        outputs.append(fn(*plain))
    for out in outputs:
        assert out.grad_fn is None and torch.equal(out, with_grad.detach())


@pytest.mark.parametrize("noise_batch", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bias_noise_lrelu_scale_equals_the_separate_multiply(rng, dtype, noise_batch):
    """A's twin and its CPU wrapper with `scale` (a conv's demodulation) give
    `x * scale` in x's dtype followed by A without it, bit for bit; a scale of
    ones changes nothing."""
    x = torch.from_numpy(rng.randn(3, 5, 6, 7).astype(np.float32)).to(dtype)
    noise = torch.from_numpy(rng.randn(noise_batch, 1, 6, 7).astype(np.float32))
    bias, strength = torch.from_numpy(rng.randn(5).astype(np.float32)), torch.tensor(0.37)
    scale = torch.from_numpy(rng.rand(3, 5).astype(np.float32) + 0.3)
    want = K.fused_bias_noise_lrelu_plain(x * scale[:, :, None, None].to(dtype), noise, bias,
                                          strength)
    # the scale rounded to x's dtype first, held in fp32: the same
    rounded = scale.to(dtype).float()
    for got in (K.fused_bias_noise_lrelu_plain(x, noise, bias, strength, scale),
                K.fused_bias_noise_lrelu_plain(x, noise, bias, strength, rounded),
                K.fused_bias_noise_lrelu(x, noise, bias, strength, scale=scale)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(K.fused_bias_noise_lrelu(x, noise, bias, strength, torch.ones(3, 5)),
                       K.fused_bias_noise_lrelu(x, noise, bias, strength))


def test_fused_bias_noise_lrelu_rejects_a_bad_scale():
    x, noise, bias, strength = torch.zeros(2, 3, 4, 4), torch.zeros(1, 1, 4, 4), torch.zeros(3), \
        torch.tensor(1.0)
    for shape in ((3, 2), (2,), (2, 3, 1, 1), (1, 3)):
        with pytest.raises(ValueError, match="bad scale shape"):
            K.fused_bias_noise_lrelu(x, noise, bias, strength, scale=torch.ones(shape))


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
    assert len(signatures) == len(build.FUNCTIONS) + len(build.ENTRY_POINTS) == 7
    bound = [(stem, symbol, argtypes) for stem, (symbol, argtypes) in build.FUNCTIONS.items()]
    for stem, symbol, argtypes in bound + list(build.ENTRY_POINTS.values()):
        assert signatures[symbol] == (stem, len(argtypes))
        assert (build.CSRC / f"{stem}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--fmad=false" in build.NVCC_FLAGS


def test_library_paths_key_on_the_sources():
    paths = {build.library_path(name) for name in build.FUNCTIONS}
    assert len(paths) == 6
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


# ---------------------------------------------------------------------------
# E. gradients through PhaseConv1Torgb
# ---------------------------------------------------------------------------


def _e_inputs(rng, nb_batch, b=2, c=5, h=5, w=7):
    """E's operands (x, v, demod, noise_bias, wrgb) at a ragged shape; w4 is
    the fold of the 3x3 weight v, as on the main path."""
    wrgb = (rng.randn(b, 4 * c, 16) * 0.2).astype(np.float32)
    wrgb[:, :, 12:] = 0.0
    return [(rng.randn(b, 4 * c, h, w) * 0.5).astype(np.float32),
            (rng.randn(c, c, 3, 3) * 0.2).astype(np.float32),
            (rng.rand(b, 4 * c) + 0.5).astype(np.float32),
            (rng.randn(nb_batch, 4 * c, h + 1, w + 1) * 0.1).astype(np.float32),
            wrgb]


def _e_port(x, v, demod, nb, wrgb):
    return K.phase_conv1_torgb(x, K.fold_conv1_weights(v), demod, nb, wrgb)


def _e_twin(x, v, demod, nb, wrgb):
    return K.phase_conv1_torgb_plain(x, K.fold_conv1_weights(v), demod, nb, wrgb)


@pytest.mark.parametrize("nb_batch", [1, 2])
def test_phase_conv1_torgb_gradients_match_twin(rng, nb_batch):
    """First and second order gradients of every operand through
    PhaseConv1Torgb (x, w4 through its 3x3 taps v, demod, a shared or
    per-sample noise_bias, wrgb) against autograd through the dense twin,
    within 1e-5 of each gradient's scale: the backward recomputes the conv
    from the nine taps, so the fp32 sums differ in order only."""
    inputs = _e_inputs(rng, nb_batch)
    y = _e_port(*[torch.tensor(v) for v in inputs])
    w = rng.randn(*y.shape).astype(np.float32)
    u = [np.asarray(rng.randn(*np.shape(v)), np.float32) for v in inputs]
    before = dict(K.LAUNCHES)
    got = _torch_grads(_e_port, inputs, w, u)
    assert K.LAUNCHES == before
    want = _torch_grads(_e_twin, inputs, w, u)
    for order in (0, 1):
        for g, t in zip(got[order], want[order]):
            scale = float(np.abs(t).max())
            assert g.shape == t.shape and scale > 0
            np.testing.assert_allclose(g, t, rtol=0, atol=1e-5 * scale)


def test_phase_conv1_torgb_w4_gradient_is_its_taps(rng):
    """w4's gradient lands on output phase 0's nine tap blocks, the entries E
    reads, and maps back through the fold to the 3x3 weight's gradient."""
    x, v, demod, nb, wrgb = (torch.tensor(a) for a in _e_inputs(rng, 1))
    w4 = K.fold_conv1_weights(v).requires_grad_(True)
    probe = torch.from_numpy(rng.randn(2, 16, 6, 8).astype(np.float32))
    (gw4,) = torch.autograd.grad((K.phase_conv1_torgb(x, w4, demod, nb, wrgb) * probe).sum(), w4)
    vv = v.clone().requires_grad_(True)
    (gv,) = torch.autograd.grad((_e_twin(x, vv, demod, nb, wrgb) * probe).sum(), vv)
    taps = K.unfold_conv1_weights(gw4)
    torch.testing.assert_close(taps, gv, rtol=0, atol=1e-5 * float(gv.abs().max()))
    rest = gw4.clone()
    rest[:5].zero_()
    assert float(rest.abs().max()) == 0.0
    assert int(torch.count_nonzero(gw4[:5])) == int(torch.count_nonzero(K.fold_conv1_weights(gv)[:5]))


# ---------------------------------------------------------------------------
# The row-streaming engine of kernels C and D (csrc/stencil4.cuh), emulated
# ---------------------------------------------------------------------------

STAGES, MAX_UNIT_THREADS, BLOCK_THREADS = 4, 512, 128  # stencil4.cuh's constants


def _ceil(a, b):
    return -(-a // b)


def stencil4_split(elem_bytes, w_out):
    """stencil4.cuh::split_column: the first column of the second launch (a
    few columns past a multiple of a warp's), or w_out."""
    v = 16 // elem_bytes
    need = _ceil(w_out, v)
    if need <= 16:
        return w_out
    base = need // 32 * 32 if need >= 32 else 16
    return base * v if 0 < need - base <= max(base // 8, 1) else w_out


def stencil4_plan(elem_bytes, planes, h_out, j_base, w_end, block_threads=BLOCK_THREADS):
    """stencil4.cuh::plan for output columns [j_base, w_end) in blocks of at
    least `block_threads`: threads per unit, units per block, column tiles,
    strip rows."""
    v = 16 // elem_bytes
    need = _ceil(w_end - j_base, v)
    if need <= 16:
        tpr = 1
        while tpr < need:
            tpr *= 2
    else:
        tpr = min(_ceil(need, 32) * 32, MAX_UNIT_THREADS)
    col_tiles = _ceil(need, tpr)
    units = block_threads // tpr if tpr < block_threads else 1
    units = min(units, 48 * 1024 // (STAGES * (tpr + 2) * 16))  # rings that fit 48 KB
    blocks_x = _ceil(planes * col_tiles, units)
    want = 132 * (2048 // (tpr * units)) * 4
    min_rows = 8 if j_base > 0 else 32  # a row's second column launch: short strips
    strips = max(min(_ceil(want, blocks_x), _ceil(h_out, min_rows)), _ceil(h_out, 256), 1)
    rh = _ceil(h_out, strips)
    return dict(v=v, tpr=tpr, units=units, col_tiles=col_tiles, tile_w=tpr * v, rh=rh,
                j_base=j_base, w_end=w_end,
                grid=(blocks_x, _ceil(h_out, rh)),
                smem=units * STAGES * (tpr + 2) * 16)


def _d_rows(taps):
    """Kernel D's Stencil16::row on (lanes, V+3) fp32 values: tap row a of
    output row k - a, partial sums in row-major tap order."""
    k = [np.float32(t) for t in taps]

    def row(acc, r, v, n_out):
        o = np.empty((v.shape[0], n_out), np.float32)
        for m in range(n_out):
            s = [None] * 4
            s[0] = k[0] * v[:, m]
            for a in range(4):
                if a:
                    s[a] = acc[(r - a) % 4][:, m]
                for b in range(int(a == 0), 4):
                    s[a] = s[a] + k[4 * a + b] * v[:, m + b]
            acc[r][:, m], acc[(r + 3) % 4][:, m], acc[(r + 2) % 4][:, m] = s[0], s[1], s[2]
            o[:, m] = s[3]
        return o

    return row


def _c_rows(taps):
    """Kernel C's Separable4::row: vertical partial sums of V+3 columns, then
    the horizontal 4-tap on the finished row."""
    t = [np.float32(v) for v in taps]

    def row(acc, r, v, n_out):
        for m in range(n_out + 3):
            for a in (3, 2, 1):
                acc[(r - a) % 4][:, m] = acc[(r - a) % 4][:, m] + t[a] * v[:, m]
        s = acc[(r + 1) % 4]
        o = np.empty((v.shape[0], n_out), np.float32)
        for m in range(n_out):
            o[:, m] = t[0] * s[:, m] + t[1] * s[:, m + 1] + t[2] * s[:, m + 2] + t[3] * s[:, m + 3]
        acc[r][:, :n_out + 3] = t[0] * v[:, :n_out + 3]
        return o

    return row


def stencil4_emulate(x, elem_bytes, row_op, pad0, w_in, h_out, w_out, misalign=0,
                     planes=None, blocks=None):
    """
    stencil4.cuh::stream_strip in numpy, lanes vectorised: the plan, strip
    starts, ring slots (loads issued 3 rows ahead into the slot of row k-1),
    16-byte chunks aligned down from each row's first needed element, chunks
    skipped outside [0, w_in), the element-wise copy of chunks that cross the
    tensor's ends, the alignment offset, the three shared loads per thread,
    the pad zeros and the stores realigned across lanes. x (P, h, ld) holds
    fp32 values (bf16 ones
    exactly); element 0 sits `misalign` elements past a 16-byte boundary.
    Slots start as NaN and every skipped chunk is NaN, so a value read but
    not zeroed shows in the output. Returns (out with NaN where nothing was
    stored, the plan, a count of chunk copies by kind).
    """
    n_planes, h, ld = x.shape
    flat = x.reshape(-1)
    n = flat.size
    base = 4096 + misalign * elem_bytes  # address of element 0
    end = base + n * elem_bytes
    out = np.full((n_planes, h_out, w_out), np.nan, np.float32)
    stored = np.zeros(out.shape, np.int32)
    copies = {"cp.async": 0, "guarded": 0}
    split = stencil4_split(elem_bytes, w_out)
    plans = [stencil4_plan(elem_bytes, planes or n_planes, h_out, 0, split)]
    if split < w_out:  # the second part, in blocks of the first part's size
        threads = plans[0]["tpr"] * plans[0]["units"]
        plans.append(stencil4_plan(elem_bytes, planes or n_planes, h_out, split, w_out, threads))
    for g in plans:
        _emulate_launch(g, flat, base, end, elem_bytes, row_op, pad0, w_in, h, ld, h_out, w_out,
                        planes or n_planes, out, stored, copies,
                        blocks if blocks is not None else
                        [(bx, by) for by in range(g["grid"][1]) for bx in range(g["grid"][0])])
    assert stored.max() <= 1, "an output was stored twice"
    return out, plans[0], copies


def _emulate_launch(g, flat, base, end, elem_bytes, row_op, pad0, w_in, h, ld, h_out, w_out,
                    planes, out, stored, copies, blocks):
    """One launch of stream_strip over `blocks`, into out and stored."""
    v, tpr, chunks = g["v"], g["tpr"], g["tpr"] + 2
    w_end, n = g["w_end"], flat.size
    lanes = np.arange(tpr)

    def store_row(o, plane, i, unit, jt):
        """stencil4.cuh::store_row: the output row's alignment a (the output
        starts on a 16-byte boundary); a lane with a previous lane in its warp
        and unit stores that lane's last a values, one at a warp's or unit's
        end stores its own."""
        def put(col, value):
            assert 0 <= col < w_out
            out[plane, i, col] = value
            stored[plane, i, col] += 1

        for lane in np.nonzero(jt < w_end)[0]:
            warp_lane = (unit * tpr + lane) % 32
            has_prev = warp_lane != 0 and lane != 0
            tail_self = warp_lane == 31 or lane == tpr - 1 or jt[lane] + v >= w_end
            count = w_end - jt[lane]
            a = ((plane * h_out + i) * w_out + jt[lane]) % v
            if has_prev:
                for m in range(a):
                    put(jt[lane] - a + m, o[lane - 1, v - a + m])
            for m in range(min(v - a, count)):
                put(jt[lane] + m, o[lane, m])
            if tail_self or a == 0:
                for m in range(v - a, min(v, count)):
                    put(jt[lane] + m, o[lane, m])

    for bx, by in blocks:
        for unit in range(g["units"]):
            unit_id = bx * g["units"] + unit
            if unit_id >= planes * g["col_tiles"] or bx >= g["grid"][0] or by >= g["grid"][1]:
                continue
            plane, tile = divmod(unit_id, g["col_tiles"])
            if plane * h * ld >= n:
                continue  # a plane the caller left out
            j0 = g["j_base"] + tile * g["tile_w"]
            cs = j0 - pad0
            i0 = by * g["rh"]
            nk = min(g["rh"], h_out - i0) + 3
            ring = np.full((STAGES, chunks, v), np.nan, np.float32)

            def row_in(k):
                return k < nk and 0 <= i0 - pad0 + k < h

            def first(k):
                return base + ((plane * h + i0 - pad0 + k) * ld + cs) * elem_bytes

            def load(k):
                if not row_in(k):
                    return
                f = first(k)
                a = f & ~15
                off = (f - a) // elem_bytes
                stage = ring[k % STAGES]
                stage[:] = np.nan  # what the slot held before: never to be used
                for c in range(chunks):
                    col = cs - off + c * v
                    if col + v <= 0 or col >= w_in:
                        continue
                    src = a + 16 * c
                    e0 = (src - base) // elem_bytes
                    if src >= base and src + 16 <= end:
                        stage[c] = flat[e0:e0 + v]
                        copies["cp.async"] += 1
                    else:
                        idx = e0 + np.arange(v)
                        ok = (idx >= 0) & (idx < n)
                        stage[c] = np.where(ok, flat[np.clip(idx, 0, n - 1)], 0.0)
                        copies["guarded"] += 1

            jt = j0 + lanes * v
            c_first = cs + lanes * v
            cols = c_first[:, None] + np.arange(v + 3)
            acc = [np.zeros((tpr, v + 3), np.float32) for _ in range(4)]
            for k in range(STAGES - 1):
                load(k)
            for k in range(nk):
                load(k + STAGES - 1)
                if row_in(k):
                    off = (first(k) & 15) // elem_bytes
                    words = np.concatenate([ring[k % STAGES, lanes + d] for d in range(3)], axis=1)
                    vals = words[:, off:off + v + 3]
                    vals = np.where((cols < 0) | (cols >= w_in), np.float32(0), vals)
                else:
                    vals = np.zeros((tpr, v + 3), np.float32)
                o = row_op(acc, k % 4, vals, v)
                if k >= 3:
                    store_row(o, plane, i0 + k - 3, unit, jt)


def _bits(values, dtype):
    return torch.from_numpy(np.ascontiguousarray(values)).to(dtype)


def _d_case(rng, h, w, pads, dtype, misalign, planes=2, taps=None):
    x = _bits(rng.randn(planes, h, w).astype(np.float32), dtype)
    taps = np.asarray(FIR_1234 + rng.randn(4, 4) * 0.01, np.float32) if taps is None else taps
    p0, p1 = pads
    h_out, w_out = h + p0 + p1 - 3, w + p0 + p1 - 3
    elem = x.element_size()
    got, g, copies = stencil4_emulate(x.float().numpy(), elem, _d_rows(taps.reshape(-1)), p0, w,
                                      h_out, w_out, misalign)
    want = K.stencil_blur4_valid_plain(x[None], taps, pads)[0]
    return _bits(got, dtype), want, g, copies


def _c_case(rng, h, wp, w_logical, dtype, misalign, planes=2, taps=TAPS_1234):
    x = rng.randn(planes, h, wp).astype(np.float32)
    x[..., w_logical:] = np.nan  # junk columns: never used
    x = _bits(x, dtype)
    got, g, copies = stencil4_emulate(x.float().numpy(), x.element_size(), _c_rows(taps), 1,
                                      w_logical, h - 1, w_logical - 1, misalign)
    want = K.blur4_separable_pad11_plain(x[None], taps, w_logical)[0]
    return _bits(got, dtype), want, g, copies


ENGINE_WIDTHS = {"1-9": range(1, 10), "63-67": range(63, 68), "1023-1025": range(1023, 1026),
                 "2049": range(2049, 2050)}  # 2049: a 512-thread unit and a capped second part


@pytest.mark.parametrize("widths", sorted(ENGINE_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil4_emulation_of_d_matches_twin_bit_for_bit(rng, widths, dtype):
    """Kernel D's index map and arithmetic through the emulated engine, at
    ragged widths, every pad pair on the path and the one-sided ones, a
    height below one strip and one of several strips (whose rows are no
    multiple of 4), and rows starting at every alignment: bit for bit with
    the twin, each output stored once, both kinds of chunk copy exercised."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    copies = {"cp.async": 0, "guarded": 0}
    for w in ENGINE_WIDTHS[widths]:
        for pads in [(0, 3), (3, 0), (2, 2), (1, 1), (0, 0), (3, 3)]:
            for h in (5, 75) if w < 100 else (6,):
                if h + sum(pads) < 4 or w + sum(pads) < 4:
                    continue
                got, want, g, c = _d_case(rng, h, w, pads, dtype, misalign=(w + h) % vec)
                assert g["tile_w"] * g["col_tiles"] >= g["w_end"] - g["j_base"]
                assert torch.equal(got, want), (w, h, pads, dtype)
                copies = {k: copies[k] + c[k] for k in c}
    assert copies["cp.async"] > 0 and copies["guarded"] > 0


@pytest.mark.parametrize("widths", sorted(ENGINE_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil4_emulation_of_c_matches_twin_bit_for_bit(rng, widths, dtype):
    """Kernel C through the emulated engine: ragged w_logical with NaN junk
    columns up to the row stride, heights below and above one strip, every
    row alignment; bit for bit with the twin."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    for w_logical in ENGINE_WIDTHS[widths]:
        if w_logical < 2:
            continue
        for extra in (0, 5):
            for h in (2, 4, 71) if w_logical < 100 else (5,):
                got, want, _, _ = _c_case(rng, h, w_logical + extra, w_logical, dtype,
                                          misalign=(w_logical + h + extra) % vec)
                assert torch.equal(got, want), (w_logical, extra, h, dtype)


@pytest.mark.parametrize("misalign", range(8))
def test_stencil4_emulation_bf16_every_row_alignment(rng, misalign):
    """bf16 rows starting at every 2-byte offset mod 16, for D and C."""
    got, want, _, _ = _d_case(rng, 9, 37, (2, 1), torch.bfloat16, misalign)
    assert torch.equal(got, want)
    got, want, _, _ = _c_case(rng, 9, 40, 37, torch.bfloat16, misalign)
    assert torch.equal(got, want)


def _nf(stage):
    """config-f's channel count at a stage (GeneratorConfig.nf)."""
    return min(int(32768 / 2.0 ** stage), 512)


def _path_shapes():
    """(kernel, batch * channels, h, w, pads) of every C and D launch on the
    1024px config-f path (chip_smoke.py's shapes)."""
    shapes = [("C", 8 * _nf(res - 1), 2 ** res + 1, 2 ** res + 1, (1, 1)) for res in range(3, 11)]
    shapes += [("D", 4 * _nf(res - 1), 2 ** res, 2 ** res, pads)
               for res in range(10, 2, -1) for pads in ((2, 2), (1, 1))]
    return shapes + [("D", 4 * 64, 1024, 1024, (2, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil4_plan_at_path_shapes(dtype):
    """At every path shape the plan fits a launch (48 KB of shared memory, the
    grid's limits, at most 512 threads), takes one column tile (the 1023- to
    1025-wide planes included; a width a few columns past a multiple of a
    warp's sends those columns to a second part of the launch, in blocks of
    the same size), gives under half of a unit's columns to idle lanes, and
    uses strips of at most 256 rows."""
    elem = 4 if dtype == torch.float32 else 2
    for kernel, planes, h, w, (p0, p1) in _path_shapes():
        h_out, w_out = h + p0 + p1 - 3, w + p0 + p1 - 3
        split = stencil4_split(elem, w_out)
        threads = None
        for lo, hi in ((0, split), (split, w_out)):
            if lo == hi:
                continue
            g = stencil4_plan(elem, planes, h_out, lo, hi, threads or BLOCK_THREADS)
            threads = threads or g["tpr"] * g["units"]
            assert g["tpr"] * g["units"] <= threads <= MAX_UNIT_THREADS and g["smem"] <= 48 * 1024
            assert g["grid"][0] < 2 ** 31 and g["grid"][1] <= 65535
            assert g["col_tiles"] == 1 and g["tile_w"] >= hi - lo
            assert g["tpr"] * g["v"] - (hi - lo) < max(g["v"], g["tile_w"] // 2), (kernel, w, g)
            assert g["rh"] <= 256 and g["grid"][1] * g["rh"] >= h_out


@pytest.mark.parametrize("kernel", ["C", "D"])
def test_stencil4_emulation_at_the_top_path_shapes(rng, kernel):
    """The largest planes of the path (1025 columns) in fp32 and bf16, the
    first plane with the plans of the whole launches (both column ranges
    where the width is split): bit for bit with the twin."""
    for dtype in (torch.float32, torch.bfloat16):
        elem = 4 if dtype == torch.float32 else 2
        if kernel == "C":
            planes, h, pads = 8 * 64, 1025, (1, 1)
            h_out, w_out = 1024, 1024
        else:
            planes, h, pads = 4 * 64, 1024, (2, 2)
            h_out, w_out = 1025, 1025
        x = _bits(rng.randn(1, h, h).astype(np.float32), dtype)
        if kernel == "C":
            got, _, _ = stencil4_emulate(x.float().numpy(), elem, _c_rows(TAPS), 1, h, h_out,
                                         w_out, planes=planes)
            want = K.blur4_separable_pad11_plain(x[None], TAPS)[0]
        else:
            got, _, _ = stencil4_emulate(x.float().numpy(), elem, _d_rows(FIR_1234.reshape(-1)),
                                         2, h, h_out, w_out, planes=planes)
            want = K.stencil_blur4_valid_plain(x[None], FIR_1234, pads)[0]
        assert torch.equal(_bits(got, dtype), want)


# ---------------------------------------------------------------------------
# Kernels A and B's index maps, emulated in numpy against the twins
# ---------------------------------------------------------------------------

A_THREADS, A_MAX_CHANNELS_PER_THREAD, A_MIN_BLOCKS = 256, 16, 2 * 132  # fused_bias_noise_lrelu.cu
B_THREADS, B_ROWS, B_UNIT_BYTES = 256, 4, 8  # upsample2x_blur.cu
SQRT2_F32 = np.float32(np.sqrt(2.0))


def _pow2_ceil(n):
    p = 1
    while p < n:
        p *= 2
    return p


def a_plan(batch, channels, units):
    """fused_bias_noise_lrelu.cu::plan: threads per block side by side over a
    plane's 16-byte units and over channels, channels per thread, grid."""
    unit_threads = A_THREADS if units >= A_THREADS else _pow2_ceil(units)
    lanes = min(A_THREADS // unit_threads, _pow2_ceil(channels))
    tiles = _ceil(units, unit_threads)
    cpt = min(A_MAX_CHANNELS_PER_THREAD, _ceil(channels, lanes))
    while cpt > 1 and tiles * _ceil(channels, lanes * cpt) * batch < A_MIN_BLOCKS:
        cpt //= 2
    return dict(unit_threads=unit_threads, lanes=lanes, cpt=cpt, tiles=tiles,
                groups=_ceil(channels, lanes * cpt))


def a_unit(elem_bytes, hw, x_offset=0, noise_offset=0):
    """fused_bias_noise_lrelu.cu::dispatch: 16 bytes of x per unit where x,
    noise (element offsets of their base pointers) and out (always aligned)
    are 16-byte aligned and H*W is a multiple of the unit; 1 element else."""
    v = 16 // elem_bytes
    aligned = (x_offset * elem_bytes) % 16 == 0 and (noise_offset * 4) % 16 == 0
    return v if aligned and hw % v == 0 else 1


def a_emulate(x, noise, bias, strength, elem_bytes, x_offset=0, noise_offset=0, plan_batch=None,
              scale=None):
    """
    bias_noise_lrelu_kernel over x (B, C, H*W) and noise (1 or B, H*W) as
    fp32 values: the plan, each thread's unit and channels, the noise read
    once per unit and kept, the arithmetic in fp32 in the kernel's order.
    With `scale` (B, C) fp32, each channel's scale[b, c] multiplies x first,
    the scale and the product each rounded to x's dtype. Returns the fp32 output (to be rounded to
    x's dtype), the plan and the unit. `plan_batch` plans the launch for a
    larger batch of which x is the first samples (blockIdx.z only picks the
    sample).
    """
    b, c, hw = x.shape
    v = a_unit(elem_bytes, hw, x_offset, noise_offset)
    g = a_plan(plan_batch or b, c, hw // v)
    assert g["unit_threads"] * g["lanes"] <= A_THREADS
    assert g["tiles"] < 2 ** 31 and g["groups"] <= 65535
    out = np.full(b * c * hw, np.nan, np.float32)
    xf, nf = x.reshape(-1), noise.reshape(-1)
    units = (np.arange(g["tiles"])[:, None] * g["unit_threads"]
             + np.arange(g["unit_threads"])[None, :]).reshape(-1)
    units = units[units * v < hw]  # the early return
    pixels = (units[:, None] * v + np.arange(v)[None, :]).reshape(-1)
    writes = 0
    for bz in range(b):
        ns = nf[(bz if noise.shape[0] > 1 else 0) * hw + pixels] * np.float32(strength)
        for gy in range(g["groups"]):
            for ty in range(g["lanes"]):
                for k in range(g["cpt"]):
                    ch = gy * g["lanes"] * g["cpt"] + ty + k * g["lanes"]
                    if ch >= c:
                        continue
                    idx = (bz * c + ch) * hw + pixels
                    xv = xf[idx]
                    if scale is not None:
                        sc = scale.reshape(-1)[bz * c + ch:bz * c + ch + 1]
                        if elem_bytes == 2:
                            sc = _bits(sc, torch.bfloat16).float().numpy()
                        xv = xv * sc[0]
                        if elem_bytes == 2:
                            xv = _bits(xv, torch.bfloat16).float().numpy()
                    val = (xv + ns) + np.float32(bias[ch])
                    out[idx] = np.where(val >= 0, val, val * np.float32(0.2)) * SQRT2_F32
                    writes += idx.size
    assert writes == out.size and not np.isnan(out).any()  # each output written once
    return out.reshape(x.shape), g, v


def _normal(rng, shape):
    """fp32 normals in bulk (RandomState makes float64 first)."""
    return np.random.default_rng(rng.randint(2 ** 31)).standard_normal(shape, dtype=np.float32)


def _a_emulation_case(rng, shape, dtype, noise_batch=1, x_offset=0, noise_offset=0,
                      plan_batch=None, scaled=False):
    b, c, h, w = shape
    x = _bits(_normal(rng, shape), dtype)
    noise = torch.from_numpy(_normal(rng, (noise_batch, 1, h, w)))
    bias = torch.from_numpy(_normal(rng, c))
    strength = torch.tensor(0.37)
    scale = torch.from_numpy(_normal(rng, (b, c))).abs().add(0.5) if scaled else None
    got, g, v = a_emulate(x.float().numpy().reshape(b, c, h * w), noise.numpy().reshape(-1, h * w),
                          bias.numpy(), 0.37, x.element_size(), x_offset, noise_offset, plan_batch,
                          None if scale is None else scale.numpy())
    got = _bits(got, dtype).reshape(shape)
    for c0 in range(0, c, 16):  # the twin is elementwise: compare in slices of channels
        cut = None if scale is None else scale[:, c0:c0 + 16]
        want = K.fused_bias_noise_lrelu_plain(x[:, c0:c0 + 16], noise, bias[c0:c0 + 16], strength,
                                              cut)
        assert torch.equal(got[:, c0:c0 + 16], want), (shape, dtype, c0)
    return g, v


def _a_path_shapes():
    """(C, r) of kernel A's launches on the 1024px config-f path."""
    return [(_nf(1), 4)] + [(_nf(res - 1), 2 ** res) for res in range(3, 11)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_emulation_at_path_shapes(rng, dtype):
    """Every A launch of the path at batch 1, planned as the batch-8 launch:
    bit for bit with the twin, each output written once, the 16-byte unit;
    the layers up to 64x64 launch at most one wave of threads."""
    for c, r in _a_path_shapes():
        g, v = _a_emulation_case(rng, (1, c, r, r), dtype, plan_batch=8)
        assert v == 16 // (4 if dtype == torch.float32 else 2)
        threads = g["tiles"] * g["groups"] * 8 * g["unit_threads"] * g["lanes"]
        if r <= 64:
            assert threads <= 132 * 2048, (c, r, g)
        else:
            assert g["unit_threads"] == A_THREADS and 8 <= g["lanes"] * g["cpt"] <= 32, (c, r, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_emulation_ragged(rng, dtype):
    """Odd H*W, C = 1, C not a multiple of the channel group, per-sample
    noise, and x and noise bases at every element offset mod 16 bytes (each
    offset other than 0 takes the scalar path): bit for bit with the twin."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    cases = [((2, 3, 5, 7), 1), ((1, 1, 9, 9), 1), ((3, 37, 8, 8), 3), ((2, 1, 1, 1), 2),
             ((2, 19, 33, 64), 2), ((1, 300, 2, 2), 1), ((4, 5, 16, 16), 4)]
    units = set()
    for shape, noise_batch in cases:
        units.add(_a_emulation_case(rng, shape, dtype, noise_batch)[1])
    for offset in range(vec):
        _, v = _a_emulation_case(rng, (2, 21, 8, 8), dtype, 2, x_offset=offset)
        assert v == (vec if offset == 0 else 1)
    for offset in range(4):
        _, v = _a_emulation_case(rng, (2, 21, 8, 8), dtype, 2, noise_offset=offset)
        assert v == (vec if offset == 0 else 1)
    assert units == {1, vec}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_emulation_with_scale(rng, dtype):
    """The scale's index, scale[b, c] for each thread's channels, at batch 2
    at config-f's 4x4 layer (512 channels) and with its top block's 64
    channels on a 32x32 plane, and in ragged launches (odd H*W, C not a
    multiple of the group, per-sample noise, x off its 16-byte boundary):
    bit for bit with the twin given the same scale."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    cases = [((2, _nf(1), 4, 4), 1, 0), ((2, _nf(9), 32, 32), 2, 0), ((2, 3, 5, 7), 2, 0),
             ((3, 37, 8, 8), 3, 0), ((2, 21, 8, 8), 2, 1)]
    units = {_a_emulation_case(rng, shape, dtype, noise_batch, x_offset=offset, scaled=True)[1]
             for shape, noise_batch, offset in cases}
    assert units == {1, vec}


def b_plan(h, w, v):
    """upsample2x_blur.cu::plan: V-column units side by side, row strips side
    by side, grid."""
    units = _ceil(w, v)
    col_threads = min(_pow2_ceil(units), B_THREADS)
    strips = B_THREADS // col_threads
    return dict(col_threads=col_threads, strips=strips, col_tiles=_ceil(units, col_threads),
                row_tiles=_ceil(h, strips * B_ROWS))


def b_emulate(x, taps, elem_bytes, x_offset=0):
    """
    upsample2x_blur_kernel over x (P, H, W) as fp32 values: the plan, each
    thread's V columns and its strip of B_ROWS rows walked with a three-row
    window of horizontal phases, zeros outside the image, the stores of the
    vector path (asserted inside the image) or the scalar path's guarded
    ones. Returns the fp32 output (P, 2H, 2W), the plan and whether the
    vector path was taken.
    """
    p, h, w = x.shape
    v = B_UNIT_BYTES // elem_bytes
    vec = w % v == 0 and (x_offset * elem_bytes) % B_UNIT_BYTES == 0
    g = b_plan(h, w, v)
    assert p * g["col_tiles"] < 2 ** 31 and g["row_tiles"] <= 65535
    k0, k1, k2, k3 = (np.float32(t) for t in taps)
    j0 = ((np.arange(g["col_tiles"])[:, None] * g["col_threads"]
           + np.arange(g["col_threads"])[None, :]).reshape(-1) * v)
    r0 = ((np.arange(g["row_tiles"])[:, None] * g["strips"]
           + np.arange(g["strips"])[None, :]).reshape(-1) * B_ROWS)
    j0, r0 = j0[j0 < w], r0[r0 < h]  # the early return
    cols = j0[:, None] - 1 + np.arange(v + 2)[None, :]  # (J, V+2): columns j0-1 .. j0+V

    def horizontal(rows):
        inside = ((rows >= 0) & (rows < h))[:, None, None] & ((cols >= 0) & (cols < w))[None]
        vals = x[:, np.clip(rows, 0, h - 1)][:, :, np.clip(cols, 0, w - 1)]  # (P, R, J, V+2)
        vals = np.where(inside[None], vals, np.float32(0))
        he = k0 * vals[..., :v] + k2 * vals[..., 1:v + 1]
        ho = k1 * vals[..., 1:v + 1] + k3 * vals[..., 2:]
        return he, ho

    out = np.full((p, 2 * h, 2 * w), np.nan, np.float32)
    writes = 0
    out_cols = j0[:, None] + np.arange(v)[None, :]  # (J, V)
    in_image = out_cols < w
    if vec:
        assert in_image.all()  # the vector path stores every column unguarded
    he_up, ho_up = horizontal(r0 - 1)
    he, ho = horizontal(r0)
    for t in range(B_ROWS):
        rows = r0 + t
        live = rows < h  # the loop's break
        he_dn, ho_dn = horizontal(rows + 1)
        for orow, a, b, e0, o0, e1, o1 in ((2 * rows, k0, k2, he_up, ho_up, he, ho),
                                           (2 * rows + 1, k1, k3, he, ho, he_dn, ho_dn)):
            even, odd = a * e0 + b * e1, a * o0 + b * o1  # (P, R, J, V)
            for parity, vals in ((0, even), (1, odd)):
                rr = np.broadcast_to(orow[:, None, None], in_image.shape[:0] + (len(rows),)
                                     + in_image.shape)
                cc = np.broadcast_to(2 * out_cols + parity, rr.shape)
                keep = live[:, None, None] & in_image[None]
                out[:, rr[keep], cc[keep]] = vals[:, keep]
                writes += int(keep.sum()) * p
        he_up, ho_up, he, ho = he, ho, he_dn, ho_dn
    assert writes == out.size and not np.isnan(out).any()  # each output written once
    return out, g, vec


def _b_emulation_case(rng, shape, dtype, taps, x_offset=0):
    x = _bits(_normal(rng, shape), dtype)
    b, c, h, w = shape
    got, g, vec = b_emulate(x.float().numpy().reshape(b * c, h, w), taps, x.element_size(),
                            x_offset)
    want = K.upsample2x_blur_plain(x, taps)
    assert torch.equal(_bits(got, dtype).reshape(want.shape), want), (shape, dtype, taps)
    return g, vec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b_emulation_at_path_shapes(rng, dtype):
    """Every B launch of the path at batch 1, (1, 3, r/2, r/2) for r = 8 ..
    1024, at the binomial and the (1, 2, 3, 4) taps: bit for bit with the
    twin, each output written once; widths of whole 8-byte units take the
    vector path."""
    vec = B_UNIT_BYTES // (4 if dtype == torch.float32 else 2)
    for res in range(3, 11):
        side = 2 ** (res - 1)
        for taps in (TAPS, TAPS_1234):
            _, vector = _b_emulation_case(rng, (1, 3, side, side), dtype, taps)
            assert vector == (side % vec == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b_emulation_ragged(rng, dtype):
    """Widths 1-9, 63-65 and 513, heights that end a strip early, and x at
    every element offset mod 16 bytes: bit for bit with the twin, the scalar
    path for ragged widths and bases off an 8-byte unit."""
    elem = 4 if dtype == torch.float32 else 2
    paths = set()
    for w in list(range(1, 10)) + [63, 64, 65, 513]:
        for h in (1, 3, 11) if w < 100 else (5,):
            paths.add(_b_emulation_case(rng, (1, 2, h, w), dtype, TAPS_1234)[1])
    for offset in range(16 // elem):
        _, vector = _b_emulation_case(rng, (2, 1, 7, 16), dtype, TAPS_1234, x_offset=offset)
        assert vector == (offset * elem % B_UNIT_BYTES == 0)
    assert paths == {True, False}
