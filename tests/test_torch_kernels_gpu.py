"""
The port's CUDA kernels against their plain twins on a GPU (marker `gpu`; they
skip without CUDA, since a CUDA kernel has no CPU mode). This file imports no
jax, so it also runs on a machine with the GPU and without JAX:

    python3 -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402
from gance_tpu_torch.ops.precision import exact_fp32  # noqa: E402

TAPS = (0.25, 0.75, 0.75, 0.25)
TAPS_1234 = (0.2, 0.4, 0.6, 0.8)  # the root of the non-symmetric FIR (1, 2, 3, 4)
FIR_1234 = np.outer((1, 2, 3, 4), (1, 2, 3, 4)) / 100.0  # a 4x4 FIR that is not symmetric


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_device(cuda_device):
    """A kernel runs on its tensors' GPU whatever the current device is, as a
    PyTorch op does: a data shard or model slot on cuda:1 while cuda:0 is
    current (before, the wrappers refused it, so every multi-GPU placement
    in one process failed at its first kernel on another card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    other = torch.device("cuda", 1)
    gen = torch.Generator(device=other).manual_seed(3)
    x = torch.randn((2, 8, 16, 16), generator=gen, device=other)
    noise = torch.randn((1, 1, 16, 16), generator=gen, device=other)
    bias = torch.randn((8,), generator=gen, device=other)
    strength = torch.tensor(0.3, device=other)
    with torch.cuda.device(0):
        got = K.fused_bias_noise_lrelu(x, noise, bias, strength)
        blurred = K.upsample2x_blur(x, TAPS)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    assert got.device == other and blurred.device == other
    torch.testing.assert_close(got, K.fused_bias_noise_lrelu_plain(x, noise, bias, strength),
                               rtol=0, atol=0)
    torch.testing.assert_close(blurred, K.upsample2x_blur_plain(x, TAPS), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "kernel", ["fused_bias_noise_lrelu", "upsample2x_blur", "blur4", "upsample2x_blur_fir1234"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_twin_on_gpu(cuda_device, kernel, dtype):
    """Kernel and twin round every operation alike, so they agree exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, 8, 33, 40), generator=gen, device=cuda_device).to(dtype)
    before = K.LAUNCHES.copy()
    if kernel == "fused_bias_noise_lrelu":
        noise = torch.randn((1, 1, 33, 40), generator=gen, device=cuda_device)
        bias = torch.randn((8,), generator=gen, device=cuda_device)
        strength = torch.tensor(0.3, device=cuda_device)
        got = K.fused_bias_noise_lrelu(x, noise, bias, strength)
        want = K.fused_bias_noise_lrelu_plain(x, noise, bias, strength)
        name = kernel
    elif kernel.startswith("upsample2x_blur"):
        taps = TAPS if kernel == "upsample2x_blur" else TAPS_1234
        got, want = K.upsample2x_blur(x, taps), K.upsample2x_blur_plain(x, taps)
        name = "upsample2x_blur"
    else:
        x[..., 33:] = float("nan")
        got = K.blur4_separable_pad11(x, TAPS, 33)
        want = K.blur4_separable_pad11_plain(x, TAPS, 33)
        name = "blur4_separable_pad11"
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert K.LAUNCHES[name] == before[name] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("batch,c4,h,w,nb_batch",
                         [(2, 20, 5, 7, 2), (1, 256, 512, 512, 1), (2, 512, 33, 40, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_conv1_torgb_matches_twin_on_gpu(cuda_device, batch, c4, h, w, nb_batch, dtype):
    """
    Kernel E against its twin on a Conv1 fold, at a small ragged shape (C = 5,
    per-sample noise_bias, partial tiles), at the 1024px block's 512^2 planes
    with C4 = 256, and at the contract's largest C4 = 512 (two slabs of
    output channels). The wrapper launches without a host sync. The twin sums
    the dense folded conv and the C4-term ToRGB product in fp32 in another
    order, so the tolerance is relative to the output's scale: fp32 1e-4 (a
    K-term fp32 sum may be off by K * 6e-8 of its terms' magnitudes, K =
    1024); bf16 1e-2 (z rounds to bf16 before the ToRGB product, and a z on a
    rounding boundary may round the other way; the output itself rounds to
    bf16, 2^-8 relative).
    """
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda_device) * scale

    c = c4 // 4
    x = randn(batch, c4, h, w, scale=0.5).to(dtype)
    w4 = K.fold_conv1_weights(randn(c, c, 3, 3, scale=(9 * c) ** -0.5))
    demod = randn(batch, c4).abs() + 0.5
    noise_bias = randn(nb_batch, c4, h + 1, w + 1, scale=0.1)
    wrgb = randn(batch, c4, 16, scale=c4 ** -0.5)
    wrgb[:, :, 12:] = 0.0
    before = K.LAUNCHES.copy()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.phase_conv1_torgb(x, w4, demod, noise_bias, wrgb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = K.phase_conv1_torgb_plain(x, w4, demod, noise_bias, wrgb)
    torch.cuda.synchronize()
    assert K.LAUNCHES["phase_conv1_torgb"] == before["phase_conv1_torgb"] + 1
    assert got.shape == (batch, 16, h + 1, w + 1) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert float(got[:, 12:].abs().max()) == 0.0
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()), err


_NOT_A_FOLD = """
import sys
import torch
sys.path.insert(0, {root!r})
from gance_tpu_torch.ops.cuda import fused_ops as K
cuda = torch.device("cuda")
x = torch.randn(1, 8, 4, 4, device=cuda)
w4 = torch.randn(8, 8, 2, 2, device=cuda)  # dense: not a Conv1 fold
torch.cuda.synchronize()
torch.cuda.set_sync_debug_mode("error")
try:
    K.phase_conv1_torgb(x, w4, torch.ones(1, 8, device=cuda),
                        torch.zeros(1, 8, 5, 5, device=cuda), torch.zeros(1, 8, 16, device=cuda))
except RuntimeError as error:  # the assert may already have failed when E launches
    if "synchroniz" in str(error):
        raise
    print(f"launch refused: {{error}}", flush=True)
print("no host sync", flush=True)
torch.cuda.set_sync_debug_mode("default")
torch.cuda.synchronize()
print("not refused", flush=True)
"""


@pytest.mark.gpu
def test_phase_conv1_torgb_refuses_a_non_fold_on_gpu(cuda_device):
    """On the card the wrapper checks that w4 is a fold with a device-side
    assert, without a host sync; the stream then fails (at E's launch, if the
    assert has already fired, or at the next sync). A failed device assert
    ends the CUDA context, so this runs in its own process."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", _NOT_A_FOLD.format(root=root)],
                          capture_output=True, text=True, timeout=600)
    assert "no host sync" in proc.stdout, proc.stderr[-2000:]
    assert "not refused" not in proc.stdout
    assert proc.returncode != 0


@pytest.mark.gpu
@pytest.mark.parametrize("pads", [(0, 0), (2, 2), (1, 1), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_blur4_valid_matches_twin_on_gpu(cuda_device, pads, dtype):
    """Kernel D and its twin sum the 16 products in one order: exact. The
    shape has partial tiles in both axes."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((2, 5, 70, 131), generator=gen, device=cuda_device).to(dtype)
    k = FIR_1234 + np.random.RandomState(0).randn(4, 4) * 0.01
    before = K.LAUNCHES["stencil_blur4_valid"]
    got = K.stencil_blur4_valid(x, k, pads)
    want = K.stencil_blur4_valid_plain(x, k, pads)
    torch.cuda.synchronize()
    assert got.shape == (2, 5, 67 + sum(pads), 128 + sum(pads)) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert K.LAUNCHES["stencil_blur4_valid"] == before + 1


def _grad_case(name, device):
    rng = np.random.RandomState(3)

    def t(*shape):
        return torch.tensor(np.asarray(rng.randn(*shape), np.float32), device=device)

    if name == "A":
        return K.fused_bias_noise_lrelu, [t(2, 8, 33, 40), t(2, 1, 33, 40), t(8), t()]
    if name == "B":
        return lambda x: K.upsample2x_blur(x, TAPS_1234), [t(2, 8, 33, 40)]
    if name == "C":
        return lambda x: K.blur4_separable_pad11(x, TAPS_1234, 33), [t(2, 8, 33, 40)]
    return lambda x: K.stencil_blur4_valid(x, FIR_1234, (2, 1)), [t(2, 8, 33, 40)]


def gradients(name, device):
    """First order d sum(f(x)^2 w) / d inputs and second order d sum(first * u)
    / d inputs, through the Function on `device`."""
    fn, inputs = _grad_case(name, device)
    inputs = [v.requires_grad_(True) for v in inputs]
    y = fn(*inputs)
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(y.shape, generator=gen).to(device)
    first = torch.autograd.grad((y.float().square() * w).sum(), inputs, create_graph=True)
    u = [torch.randn(v.shape, generator=gen).to(device) for v in inputs]
    second = torch.autograd.grad(sum((g * v).sum() for g, v in zip(first, u)), inputs,
                                 allow_unused=True)
    second = [torch.zeros_like(v) if g is None else g for v, g in zip(inputs, second)]
    return [g.detach().cpu() for g in first], [g.detach().cpu() for g in second]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["A", "B", "C", "D"])
def test_function_gradients_on_gpu_match_cpu(cuda_device, name):
    """First- and second-order gradients through the Function on the card
    against the same gradients through the twin on the CPU, within 1e-4 of
    each gradient's scale; a cut gradient would give zeros. C's and D's
    backward launch kernel D."""
    before = K.LAUNCHES["stencil_blur4_valid"]
    got = gradients(name, cuda_device)
    torch.cuda.synchronize()
    want = gradients(name, torch.device("cpu"))
    for order in (0, 1):
        for g, r in zip(got[order], want[order]):
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= 1e-4 * max(scale, 1e-6)
    assert all(float(g.abs().max()) > 0 for g in got[0])
    if name in ("C", "D"):
        assert K.LAUNCHES["stencil_blur4_valid"] > before


RAGGED_WIDTHS = list(range(1, 10)) + list(range(63, 68)) + list(range(1023, 1026)) + [2049]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stencil_blur4_valid_ragged_on_gpu(cuda_device, dtype):
    """Kernel D bit for bit against its twin at the engine's ragged cases:
    widths 1-9, 63-67 and 1023-1025 (below one thread's 16 bytes, below a
    warp, one past a power of two), heights below one strip and over several,
    every pad pair (p0, p1) in {0..3}^2 and a non-symmetric FIR."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    k = FIR_1234 + np.random.RandomState(1).randn(4, 4) * 0.01
    launches = K.LAUNCHES["stencil_blur4_valid"]
    count = 0
    for w in RAGGED_WIDTHS:
        for h in (3, 7, 300) if w < 100 else (4, 130):
            x = torch.randn((2, 3, h, w), generator=gen, device=cuda_device).to(dtype)
            for p0 in range(4):
                for p1 in range(4):
                    if h + p0 + p1 < 4 or w + p0 + p1 < 4:
                        continue
                    got = K.stencil_blur4_valid(x, k, (p0, p1))
                    want = K.stencil_blur4_valid_plain(x, k, (p0, p1))
                    assert torch.equal(got, want), (h, w, p0, p1)
                    count += 1
    torch.cuda.synchronize()
    assert K.LAUNCHES["stencil_blur4_valid"] == launches + count


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blur4_separable_pad11_ragged_on_gpu(cuda_device, dtype):
    """Kernel C bit for bit against its twin at ragged w_logical (2-9, 63-67,
    1023-1025), with NaN junk columns up to the row stride, heights below one
    strip and over several, the binomial and the non-symmetric FIR."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for w_logical in RAGGED_WIDTHS[1:]:
        for extra in (0, 3, 9):
            for h in (2, 5, 300) if w_logical < 100 else (3, 130):
                x = torch.randn((2, 3, h, w_logical + extra), generator=gen,
                                device=cuda_device).to(dtype)
                x[..., w_logical:] = float("nan")
                for taps in (TAPS, TAPS_1234):
                    got = K.blur4_separable_pad11(x, taps, w_logical)
                    want = K.blur4_separable_pad11_plain(x, taps, w_logical)
                    assert torch.equal(got, want), (h, w_logical, extra, taps)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 1, 1), (1, 5, 7, 33), (3, 2, 40, 31), (8, 64, 512, 512)])
def test_blur4_separable_pad11_phases_matches_c_on_gpu(cuda_device, shape):
    """Kernel C over the four phase planes (B, C, h, w gives p_ij of (h+1-i) x
    (w+1-j)) against C on their interleave and against its twin: equal bits,
    one launch counted as C's; odd and even sizes, one sample a plane, one
    row pair, several strips, and the largest `Conv0_up` shape."""
    b, c, h, w = shape
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    phases = [torch.randn((b, c, h + 1 - i, w + 1 - j), generator=gen, device=cuda_device)
              for i in (0, 1) for j in (0, 1)]
    for taps in (TAPS, TAPS_1234):
        launches = K.LAUNCHES["blur4_separable_pad11"]
        got = K.blur4_separable_pad11_phases(phases, taps)
        assert K.LAUNCHES["blur4_separable_pad11"] == launches + 1
        assert got.shape == (b, c, 2 * h, 2 * w)
        assert torch.equal(got, K.blur4_separable_pad11(K.interleave_phases2(phases), taps))
        assert torch.equal(got, K.blur4_separable_pad11_phases_plain(phases, taps))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", range(8))
def test_stencils_bf16_at_every_row_alignment_on_gpu(cuda_device, offset):
    """bf16 inputs that start `offset` elements (2 bytes each) past a 16-byte
    boundary, with odd widths, so that rows start at every alignment; the
    outputs land misaligned too. C and D bit for bit against their twins."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    shape = (2, 4, 37, 41)
    n = int(np.prod(shape))
    buf = torch.randn(n + 16, generator=gen, device=cuda_device).to(torch.bfloat16)
    x = buf[offset:offset + n].view(shape)
    assert x.data_ptr() % 16 == 2 * offset
    for pads in [(2, 2), (1, 1), (0, 3), (3, 0)]:
        assert torch.equal(K.stencil_blur4_valid(x, FIR_1234, pads),
                           K.stencil_blur4_valid_plain(x, FIR_1234, pads)), pads
    for w_logical in (41, 38):
        assert torch.equal(K.blur4_separable_pad11(x, TAPS_1234, w_logical),
                           K.blur4_separable_pad11_plain(x, TAPS_1234, w_logical)), w_logical
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_phase_conv1_torgb_gradients_on_gpu_match_cpu(cuda_device):
    """First and second order gradients through E's Function on the card (the
    forward launches kernel E) against the same through the dense twin on
    the CPU, within 1e-4 of each gradient's scale (E's fp32 sums and cuDNN's
    take another order than the CPU's)."""
    rng = np.random.RandomState(8)
    b, c, h = 2, 16, 9
    arrays = [(rng.randn(b, 4 * c, h, h) * 0.5), rng.randn(c, c, 3, 3) * (9 * c) ** -0.5,
              rng.rand(b, 4 * c) + 0.5, rng.randn(1, 4 * c, h + 1, h + 1) * 0.1,
              rng.randn(b, 4 * c, 16) * (4 * c) ** -0.5]
    arrays[4][:, :, 12:] = 0.0

    def grads(device):
        ts = [torch.tensor(np.asarray(a, np.float32), device=device, requires_grad=True)
              for a in arrays]
        fn = K.phase_conv1_torgb if device != "cpu" else K.phase_conv1_torgb_plain
        y = fn(ts[0], K.fold_conv1_weights(ts[1]), *ts[2:])
        gen = torch.Generator().manual_seed(9)
        w = torch.randn(y.shape, generator=gen).to(device)
        first = torch.autograd.grad((y.square() * w).sum(), ts, create_graph=True)
        u = [torch.randn(t.shape, generator=gen).to(device) for t in ts]
        second = torch.autograd.grad(sum((g * v).sum() for g, v in zip(first, u)), ts)
        return [g.detach().cpu() for g in first + second]

    launches = K.LAUNCHES["phase_conv1_torgb"]
    with exact_fp32():  # the double backward's convolutions too: no TF32
        got = grads(cuda_device)
    torch.cuda.synchronize()
    assert K.LAUNCHES["phase_conv1_torgb"] == launches + 1
    for g, r in zip(got, grads("cpu")):
        scale = float(r.abs().max())
        assert scale > 0 and float((g - r).abs().max()) <= 1e-4 * scale


def _at_offset(shape, offset, dtype, gen, device):
    """A contiguous tensor of `shape` whose base lies `offset` elements past a
    16-byte boundary: a slice of a larger one, as a view with a storage offset."""
    n = int(np.prod(shape))
    buf = torch.randn(n + 16, generator=gen, device=device).to(dtype)
    t = buf[offset:offset + n].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == offset * t.element_size() % 16
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bias_noise_lrelu_ragged_on_gpu(cuda_device, dtype):
    """Kernel A bit for bit against its twin (atol 0) where its 16-byte path
    does not apply or its plan is ragged: odd H*W, C = 1, C not a multiple of
    the channel group, per-sample noise, x and noise at every element offset
    mod 16 bytes; and at training's (4, 64, 64, 64) with per-sample noise."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    strength = torch.tensor(0.37, device=cuda_device)
    vec = 16 // (4 if dtype == torch.float32 else 2)
    cases = [((2, 3, 5, 7), 1, 0, 0), ((1, 1, 9, 9), 1, 0, 0), ((3, 37, 8, 8), 3, 0, 0),
             ((2, 1, 1, 1), 2, 0, 0), ((2, 19, 33, 64), 2, 0, 0), ((1, 300, 2, 2), 1, 0, 0),
             ((4, 64, 64, 64), 4, 0, 0)]
    cases += [((2, 21, 8, 8), 2, off, 0) for off in range(1, vec)]
    cases += [((2, 21, 8, 8), 2, 0, off) for off in range(1, 4)]
    cases += [((2, 21, 9, 9), 1, 3, 1)]
    launches = K.LAUNCHES["fused_bias_noise_lrelu"]
    for shape, noise_batch, x_off, noise_off in cases:
        b, c, h, w = shape
        x = _at_offset(shape, x_off, dtype, gen, cuda_device)
        noise = _at_offset((noise_batch, 1, h, w), noise_off, torch.float32, gen, cuda_device)
        bias = torch.randn((c,), generator=gen, device=cuda_device)
        got = K.fused_bias_noise_lrelu(x, noise, bias, strength)
        want = K.fused_bias_noise_lrelu_plain(x, noise, bias, strength)
        assert torch.equal(got, want), (shape, noise_batch, x_off, noise_off)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_bias_noise_lrelu"] == launches + len(cases)


def _config_f_channels(stage):
    """config-f's channel count at a stage (GeneratorConfig.nf)."""
    return min(32768 >> stage, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bias_noise_lrelu_scale_equals_separate_multiply_on_gpu(cuda_device, dtype):
    """Kernel A with `scale` (a conv's demodulation, applied in A's pass)
    equals `x * scale` in x's dtype followed by A without it, bit for bit
    (atol 0): at config-f's channels on every side from 4 to 1024, batch 1
    and 8, constant (1, 1, H, W) and per-sample (B, 1, H, W) noise, and on
    the scalar path (x at an element offset, odd H*W). One launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    strength = torch.tensor(0.37, device=cuda_device)
    sides = [(_config_f_channels(1), 4)] + [(_config_f_channels(r - 1), 2 ** r)
                                             for r in range(3, 11)]
    cases = [((b, c, r, r), noise_batch, 0) for c, r in sides for b in (1, 8)
             for noise_batch in sorted({1, b})]
    cases += [((8, 64, 33, 33), 8, 0), ((2, 21, 9, 9), 1, 1), ((8, 512, 16, 16), 1, 3)]
    for shape, noise_batch, offset in cases:
        b, c, h, w = shape
        x = _at_offset(shape, offset, dtype, gen, cuda_device)
        noise = torch.randn((noise_batch, 1, h, w), generator=gen, device=cuda_device)
        bias = torch.randn((c,), generator=gen, device=cuda_device)
        scale = torch.rand((b, c), generator=gen, device=cuda_device) + 0.05
        launches = K.LAUNCHES["fused_bias_noise_lrelu"]
        got = K.fused_bias_noise_lrelu(x, noise, bias, strength, scale=scale)
        assert K.LAUNCHES["fused_bias_noise_lrelu"] == launches + 1
        want = K.fused_bias_noise_lrelu(x * scale[:, :, None, None].to(dtype), noise, bias,
                                        strength)
        assert torch.equal(got, want), (shape, noise_batch, offset)
        del x, got, want
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_blur_ragged_on_gpu(cuda_device, dtype):
    """Kernel B bit for bit against its twin (atol 0) with the (1, 2, 3, 4)
    taps at widths 1, 2, 3, 5 and 513 (below one 16-byte unit, odd), heights
    that end a strip early, and x at every element offset mod 16 bytes."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    vec = 16 // (4 if dtype == torch.float32 else 2)
    cases = [((2, 3, h, w), 0) for w in (1, 2, 3, 5, 513) for h in (1, 6, 37)]
    cases += [((2, 3, 7, 64), off) for off in range(vec)]
    launches = K.LAUNCHES["upsample2x_blur"]
    for shape, offset in cases:
        x = _at_offset(shape, offset, dtype, gen, cuda_device)
        for taps in (TAPS_1234, TAPS):
            got, want = K.upsample2x_blur(x, taps), K.upsample2x_blur_plain(x, taps)
            assert torch.equal(got, want), (shape, offset, taps)
    torch.cuda.synchronize()
    assert K.LAUNCHES["upsample2x_blur"] == launches + 2 * len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("noise_batch", [2, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_gradients_on_gpu_match_cpu(cuda_device, noise_batch, dtype):
    """The projector differentiates the noise planes: kernel A's noise
    gradient (per-frame planes (B, 1, H, W), or one plane summed over the
    batch) and kernel E's `noise_bias` gradient (per-frame (B, 4C, h+1, w+1)),
    on the card (A and E launched) against the same Functions over the CPU
    twins, within 1e-5 of each gradient's scale (the same products, summed
    over channels in another order)."""
    rng = np.random.RandomState(10)
    b, c, h = 2, 16, 9
    a_inputs = [rng.randn(b, 8, 33, 40), rng.randn(noise_batch, 1, 33, 40), rng.randn(8),
                np.float32(0.3)]
    e_inputs = [rng.randn(b, 4 * c, h, h) * 0.5, rng.randn(c, c, 3, 3) * (9 * c) ** -0.5,
                rng.rand(b, 4 * c) + 0.5, rng.randn(noise_batch, 4 * c, h + 1, h + 1) * 0.1,
                rng.randn(b, 4 * c, 16) * (4 * c) ** -0.5]
    e_inputs[4][:, :, 12:] = 0.0

    def noise_grads(device):
        x, noise, bias, strength = (torch.tensor(np.asarray(a, np.float32), device=device)
                                    for a in a_inputs)
        noise.requires_grad_(True)
        y = K.fused_bias_noise_lrelu(x.to(dtype), noise, bias, strength)
        probe = torch.tensor(rng_probe.randn(*y.shape).astype(np.float32), device=device)
        (ga,) = torch.autograd.grad((y.float() * probe).sum(), noise)
        ex, v, demod, nb, wrgb = (torch.tensor(np.asarray(a, np.float32), device=device)
                                  for a in e_inputs)
        nb.requires_grad_(True)
        z = K.phase_conv1_torgb(ex.to(dtype), K.fold_conv1_weights(v), demod, nb, wrgb)
        probe = torch.tensor(rng_probe.randn(*z.shape).astype(np.float32), device=device)
        (ge,) = torch.autograd.grad((z.float() * probe).sum(), nb)
        return ga.cpu(), ge.cpu()

    launches = dict(K.LAUNCHES)
    rng_probe = np.random.RandomState(11)
    with exact_fp32():
        got = noise_grads(cuda_device)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_bias_noise_lrelu"] == launches["fused_bias_noise_lrelu"] + 1
    assert K.LAUNCHES["phase_conv1_torgb"] == launches["phase_conv1_torgb"] + 1
    rng_probe = np.random.RandomState(11)
    want = noise_grads("cpu")
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.shape[0] == noise_batch
        scale = float(r.abs().max())
        assert scale > 0 and float((g - r).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("phase", [False, True])
def test_projector_step_gradients_on_gpu_match_cpu(cuda_device, monkeypatch, phase):
    """One projection step's loss and its w and noise-plane gradients at 32px
    (top block of 64 channels, so that the phase path applies; non-zero noise
    strengths; the top block on the phase path when `phase`) on the card
    against the port's CPU path: loss within
    1e-4 relative, gradients norm-wise within 2e-2 (w, and the planes taken
    together): one lrelu input at the fp32 kink moves a whole gradient by
    about 0.4% (chip_smoke.py phase 7a's bound and reason)."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig, init_generator_params
    from gance_tpu_torch.projection.projector import Projector, ProjectorSettings

    config = GeneratorConfig(resolution=32, fmap_base=1024, fmap_max=128)
    params = init_generator_params(12, config)
    rng = np.random.RandomState(12)
    for name, block in params["synthesis"].items():
        for layer in block.values() if name != "noise" else ():
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(rng.uniform(0.05, 0.3))
    w = rng.randn(2, 512).astype(np.float32) * 0.5
    planes = [rng.randn(2, 1, *params["synthesis"]["noise"][f"noise{i}"].shape[2:])
              .astype(np.float32) for i in range(len(params["synthesis"]["noise"]))]
    targets = (rng.rand(2, 32, 32, 3) * 255).astype(np.uint8)
    jitter = (rng.randn(2, 512) * 0.05).astype(np.float32)

    def step(device):
        projector = Projector(params, config, device=device,
                              settings=ProjectorSettings(dlatent_avg_samples=16))
        loss, _, _, grads = projector._loss_and_gradients(
            torch.tensor(w, device=device), [torch.tensor(p, device=device) for p in planes],
            projector._target_proc(targets), torch.tensor(jitter, device=device))
        return float(loss), [g.cpu() for g in grads]

    monkeypatch.setenv("GANCE_TPU_PHASE1024", "on" if phase else "off")
    launches = K.LAUNCHES["phase_conv1_torgb"]
    got_loss, got = step(cuda_device)
    assert K.LAUNCHES["phase_conv1_torgb"] == launches + int(phase)
    want_loss, want = step("cpu")
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    assert float((got[0] - want[0]).norm() / want[0].norm()) <= 2e-2
    g_planes = torch.cat([g.reshape(-1) for g in got[1:]])
    w_planes = torch.cat([g.reshape(-1) for g in want[1:]])
    assert float((g_planes - w_planes).norm() / w_planes.norm()) <= 2e-2


def _conv0_up_largest():
    """The largest `Conv0_up` of config-f 1024px at batch 8: x (8, 128, 512,
    512) to 64 channels at 1024x1024."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig

    config = GeneratorConfig()
    top = config.resolution_log2
    return (8, config.nf(top - 2), 2 ** (top - 1), 2 ** (top - 1)), config.nf(top - 1)


def _conv0_up_operands(gen, device, x_shape, cout):
    x = torch.randn(x_shape, generator=gen, device=device)
    w = torch.randn((cout, x_shape[1], 3, 3), generator=gen, device=device)
    return x, w / (9 * x_shape[1]) ** 0.5


@pytest.mark.gpu
def test_upsample_conv_2d_repeats_itself_on_gpu(cuda_device):
    """Three calls of the `Conv0_up` computation (phases, then kernel C) at its
    largest shape in fp32 under cuDNN's default algorithms give equal bits:
    the phases are forward convs. A transposed conv's forward, cuDNN's
    backward-data pass, gave 1024px frames 1 uint8 step apart between calls."""
    from gance_tpu_torch.ops.upfirdn2d import upsample_conv_2d

    assert not torch.backends.cudnn.deterministic
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x, w = _conv0_up_operands(gen, cuda_device, *_conv0_up_largest())
    with torch.inference_mode(), exact_fp32():
        first = upsample_conv_2d(x, w)
        again = [upsample_conv_2d(x, w) for _ in range(2)]
    torch.cuda.synchronize()
    assert first.shape == (8, 64, 1024, 1024)
    for y in again:
        assert torch.equal(y, first)


@pytest.mark.gpu
def test_transposed_conv_phases_match_conv_transpose2d_on_gpu(cuda_device):
    """The phases against cuDNN's transposed conv at the largest `Conv0_up`
    shape, fp32 without TF32: within 1e-5 of max |ref| (the same products,
    summed in another order)."""
    from gance_tpu_torch.ops.upfirdn2d import transposed_conv_phases

    gen = torch.Generator(device=cuda_device).manual_seed(18)
    x, w = _conv0_up_operands(gen, cuda_device, *_conv0_up_largest())
    with torch.inference_mode(), exact_fp32():
        got = transposed_conv_phases(x, w, 2)
        want = torch.nn.functional.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), stride=2)
    assert got.shape == want.shape == (8, 64, 1025, 1025)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_upsample_conv_2d_gradients_on_gpu_match_cpu(cuda_device):
    """d/dx and d/dw through the phases and kernel C on the card against the
    same through C's twin on the CPU, within 1e-4 of each gradient's scale."""
    from gance_tpu_torch.ops.upfirdn2d import upsample_conv_2d

    gen = torch.Generator().manual_seed(19)
    x, w = _conv0_up_operands(gen, "cpu", (2, 16, 33, 40), 8)
    g = torch.randn((2, 8, 66, 80), generator=gen)

    def grads(device):
        xt = x.to(device).requires_grad_(True)
        wt = w.to(device).requires_grad_(True)
        (upsample_conv_2d(xt, wt) * g.to(device)).sum().backward()
        return xt.grad.cpu(), wt.grad.cpu()

    launches = K.LAUNCHES["blur4_separable_pad11"]
    with exact_fp32():
        got = grads(cuda_device)
    torch.cuda.synchronize()
    assert K.LAUNCHES["blur4_separable_pad11"] == launches + 1
    for r, h in zip(grads("cpu"), got):
        scale = float(r.abs().max())
        assert scale > 0 and float((h - r).abs().max()) <= 1e-4 * scale
