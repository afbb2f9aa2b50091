"""
The port's CUDA kernels against their plain twins on a GPU (marker `gpu`; they
skip without CUDA, since a CUDA kernel has no CPU mode). This file imports no
jax, so it also runs on a machine with the GPU and without JAX:

    python3 -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import pytest

torch = pytest.importorskip("torch")

from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402

TAPS = (0.25, 0.75, 0.75, 0.25)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_bias_noise_lrelu", "upsample2x_blur", "blur4"])
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
    elif kernel == "upsample2x_blur":
        got, want, name = K.upsample2x_blur(x), K.upsample2x_blur_plain(x), kernel
    else:
        x[..., 33:] = float("nan")
        got = K.blur4_separable_pad11(x, TAPS, 33)
        want = K.blur4_separable_pad11_plain(x, TAPS, 33)
        name = "blur4_separable_pad11"
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert K.LAUNCHES[name] == before[name] + 1
