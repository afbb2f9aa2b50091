"""
The port's synthesis kernels A, B and C (gance_tpu_torch/ops/cuda) on the CPU:
each kernel's plain PyTorch twin against the Pallas function it replaces, run
in interpret mode, at the shapes of tests/test_pallas_ops.py plus a C=64 case
with an odd w_logical (the 1024px top block); B at a FIR that is not symmetric
against JAX's polyphase form; the wrappers' CPU dispatch and input checks; and
the ctypes binding of all four kernels against the C signatures in csrc/.
Kernel E's twin is held against its Pallas kernel in
tests/test_torch_phase_block.py. The kernels
themselves run only on a GPU: tests/test_torch_kernels_gpu.py holds each
against its twin there, and `python3 chip_smoke.py` does so at the 1024px
shapes.
"""

import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.ops.pallas import fused_ops as pallas  # noqa: E402
from gance_tpu.ops.upfirdn2d import upsample2x_polyphase_nchw  # noqa: E402
from gance_tpu_torch.ops.cuda import build  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402

TAPS = (0.25, 0.75, 0.75, 0.25)
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
    assert len(signatures) == len(build.FUNCTIONS) == 4
    for stem, (symbol, argtypes) in build.FUNCTIONS.items():
        assert signatures[symbol] == (stem, len(argtypes))
        assert (build.CSRC / f"{stem}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--fmad=false" in build.NVCC_FLAGS


def test_library_paths_key_on_the_sources():
    paths = {build.library_path(name) for name in build.FUNCTIONS}
    assert len(paths) == 4
    for path in paths:
        assert path.parent == build.BUILD_DIR
        assert re.fullmatch(r"\w+-[0-9a-f]{16}\.so", path.name)
