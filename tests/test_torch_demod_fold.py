"""
Kernel A applying each synthesis conv's demodulation (`scale`): the
synthesis layers that end in A hand it the demodulation unapplied
(`modulated_conv2d_undemodulated`), and the frames equal those of the same
forward with the separate `y * demod` multiply, bit for bit, at fp32 and
bf16, on the CPU and on a GPU (there also at config-f's widths with the
benchmark's weights); A's counters name the route it took; and where
autograd may ask for a gradient (the projector, the trainer) the multiply
still runs on its own, so their gradients and steps are unchanged. The
kernel itself is held against the separate multiply on the card in
tests/test_torch_kernels_gpu.py. The GPU cases (marker `gpu`) skip without
CUDA; on a machine without JAX run them with

    python3 -m pytest --noconftest tests/test_torch_demod_fold.py -m gpu -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gance_tpu_torch.models import stylegan2 as G
from gance_tpu_torch.ops.cuda import fused_ops as K
from gance_tpu_torch.ops.modulated_conv import (
    modulated_conv2d,
    modulated_conv2d_undemodulated,
)
from gance_tpu_torch.projection import projector as P
from gance_tpu_torch.synthesis.runtime import SynthesisNetwork
from gance_tpu_torch.utils import profiling

CONFIG = G.GeneratorConfig(resolution=32, fmap_base=512, fmap_max=64, latent_size=32,
                           dlatent_size=32, mapping_layers=2, mapping_fmaps=32)
FOLDED, SEPARATE = "ops.demod_folded", "ops.demod_separate"
ROOT = Path(__file__).resolve().parents[1]
CUDA = pytest.param("cuda", marks=pytest.mark.gpu)


def on(device):
    """`device`, skipping where it is a GPU and there is none."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernel A has no CPU mode)")
    return device


@pytest.fixture(autouse=True)
def empty_counters():
    profiling.reset()
    yield
    profiling.reset()


def generator_params(seed: int) -> dict:
    """Random params with non-zero noise strengths and biases, so that noise,
    bias and the lrelu's negative side all reach the frames."""
    params = G.init_generator_params(seed, CONFIG)
    rng = np.random.RandomState(seed)
    for name, block in params["synthesis"].items():
        for layer in block.values() if name != "noise" else ():
            if "bias" in layer:
                layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(rng.uniform(0.1, 0.3))
    return params


def undeferred(monkeypatch):
    """Run every synthesis layer as before the fold: the demodulation is
    multiplied in on its own and A gets no scale."""
    real = G.fused_bias_noise_lrelu

    def separate(x, noise, bias, strength, scale=None):
        if scale is not None:
            x = x * scale[:, :, None, None].to(x.dtype)
        return real(x, noise, bias, strength)

    monkeypatch.setattr(G, "fused_bias_noise_lrelu", separate)


def counted(fn):
    """fn() under a CPU profiler (the counters record only then), and the counters."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.counters()


@pytest.mark.parametrize("device", ["cpu", CUDA])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_synthesis_frames_equal_the_separate_multiply(monkeypatch, dtype, device):
    """SynthesisNetwork's uint8 frames (inference mode, A folding every
    demodulation) equal the same forward with the separate multiply, bit for
    bit; every noise-carrying layer folds, none multiplies on its own."""
    network = SynthesisNetwork(params=generator_params(3), config=CONFIG, compute_dtype=dtype,
                               device=on(device))
    z = np.random.RandomState(4).randn(5, CONFIG.latent_size).astype(np.float32)
    folded, counts = counted(lambda: network.device_images_from_vectors(z))
    layers = CONFIG.num_style_rows - 1  # every conv but ToRGB carries noise
    assert counts.get(FOLDED) == layers and counts.get(SEPARATE, 0) == 0
    undeferred(monkeypatch)
    separate, counts = counted(lambda: network.device_images_from_vectors(z))
    assert counts.get(FOLDED, 0) == 0 and counts.get(SEPARATE, 0) == 0
    assert folded.dtype == torch.uint8 and torch.equal(folded, separate)


@pytest.mark.gpu
@pytest.mark.parametrize("config_name,dtype", [("stylegan2-f-1024", torch.float32),
                                               ("stylegan2-f-1024", torch.bfloat16),
                                               ("stylegan2-f-256", torch.float32)])
def test_benchmark_frames_equal_the_separate_multiply_on_gpu(monkeypatch, config_name, dtype):
    """The render cells' network (port_bench's configuration file and seeded
    weights, config-f's widths) renders 48 frames of one seed with the fold
    and with the separate multiply: the uint8 frames are equal, bit for bit."""
    on("cuda")
    from port_bench.harness import program, traffic, weights

    monkeypatch.setenv("GANCE_TPU_PHASE1024", "off")  # as the cells pin it

    seed = 2**31 + 21
    config = json.loads((ROOT / "port_bench" / "configs" / f"{config_name}.json").read_text())
    network = SynthesisNetwork(params=weights.generator_params(config, seed, "cuda"),
                               config=program.generator_config(config),
                               truncation_psi=config["truncation_psi"], compute_dtype=dtype,
                               device="cuda")
    z = traffic.z_rows(48, config["latent_size"], seed)

    def frames():
        return torch.cat([network.device_images_from_vectors(z[i:i + 8])
                          for i in range(0, len(z), 8)])

    folded, counts = counted(frames)
    assert counts.get(FOLDED) == 6 * (network.config.num_style_rows - 1)
    undeferred(monkeypatch)
    assert torch.equal(folded, frames())


def test_noise_free_layers_keep_the_separate_multiply(monkeypatch):
    """noise_mode 'none' ends each layer in bias_act: A is never called."""
    network = SynthesisNetwork(params=G.init_generator_params(5, CONFIG), config=CONFIG,
                               device="cpu")
    w = torch.from_numpy(np.random.RandomState(6).randn(
        2, CONFIG.num_style_rows, CONFIG.dlatent_size).astype(np.float32))

    def refused(*args, **kwargs):
        raise AssertionError("kernel A called on a layer without noise")

    monkeypatch.setattr(G, "fused_bias_noise_lrelu", refused)
    with torch.inference_mode():
        images = G.synthesis_apply(network.params, w, CONFIG, noise_mode="none")
    assert images.shape == (2, CONFIG.resolution, CONFIG.resolution, CONFIG.num_channels)


def test_projector_step_is_unchanged_and_keeps_the_separate_multiply(monkeypatch):
    """Two projector steps (w and the noise planes differentiated through
    every demodulation) give the same latents, planes and distances as with
    the fold taken out: under autograd A gets `x * scale` from PyTorch."""
    params = generator_params(7)
    rng = np.random.RandomState(8)
    targets = (rng.rand(2, CONFIG.resolution, CONFIG.resolution, 3) * 255).astype(np.uint8)
    w0 = rng.randn(2, CONFIG.dlatent_size).astype(np.float32)

    def project():
        projector = P.Projector(params, CONFIG, settings=P.ProjectorSettings(
            num_steps=2, dlatent_avg_samples=16), device="cpu")
        return projector.project_batch(targets, initial_latents=w0, want_step_images=False)

    folded, counts = counted(project)
    assert counts.get(SEPARATE, 0) > 0  # the steps' forwards
    undeferred(monkeypatch)
    separate = project()
    for a, b in zip(folded, separate):
        np.testing.assert_array_equal(a.final_latents, b.final_latents)
        for x, y in zip(a.noises, b.noises):
            np.testing.assert_array_equal(x, y)
        assert a.final_distance == b.final_distance


@pytest.mark.parametrize("up", [False, True])
def test_gradients_through_the_deferred_demod_equal_the_separate_multiply(rng, up):
    """With inputs that require grad, the layer (conv, demodulation, A) and
    its gradients to x, w, the weights, the noise, the bias and the strength
    are those of the separate multiply, bit for bit; A runs its Function."""
    b, cin, cout, side = 2, 6, 5, 7
    leaves = [rng.randn(b, cin, side, side), rng.randn(b, 8), rng.randn(cout, cin, 3, 3),
              rng.randn(8, cin), 0.1 * rng.randn(cin)]
    out_side = 2 * side if up else side
    noise, bias = rng.randn(1, 1, out_side, out_side), 0.1 * rng.randn(cout)
    probe = torch.from_numpy(rng.randn(b, cout, out_side, out_side).astype(np.float32))

    def grads(defer):
        ts = [torch.tensor(np.asarray(v, np.float32), requires_grad=True)
              for v in (*leaves, noise, bias, 0.2)]
        x, w, weight, mod_weight, mod_bias, n, bi, strength = ts
        if defer:
            y, demod = modulated_conv2d_undemodulated(x, w, weight, mod_weight, mod_bias,
                                                      up=up)
            out = K.fused_bias_noise_lrelu(y, n, bi, strength, scale=demod)
        else:
            y = modulated_conv2d(x, w, weight, mod_weight, mod_bias, up=up)
            out = K.fused_bias_noise_lrelu(y, n, bi, strength)
        assert type(out.grad_fn).__name__ == "FusedBiasNoiseLrelu" + "Backward"
        return [out.detach()] + list(torch.autograd.grad((out * probe).sum(), ts))

    (folded, counts), separate = counted(lambda: grads(True)), grads(False)
    assert counts == {SEPARATE: 1}
    for got, want in zip(folded, separate):
        assert torch.equal(got, want)
