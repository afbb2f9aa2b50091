"""
StyleGAN3-T on the card (marker `gpu`; skips without CUDA, since kernel F has
no CPU mode): kernel F against its twin at every layer shape of the 1024px
network at batch 8 and at its schedule's edges, F's refusals, F under
autograd (the kernel forward, the twin's gradient), and the port's 1024px
frames against the plain reference.
This file imports no jax:

    python3 -m pytest --noconftest tests/test_torch_stylegan3_gpu.py -m gpu -q
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gance_tpu_torch.models import stylegan3 as S  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402
from gance_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain  # noqa: E402
from gance_tpu_torch.ops.precision import exact_fp32  # noqa: E402

T1024 = S.StyleGAN3Config()
F_LAYERS = [g for g in S.synthesis_geometry(T1024)[1] if not g.is_torgb]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernel F has no CPU mode)")
    return torch.device("cuda")


def layer_inputs(geo, batch, device, seed=0):
    """A conv output of the layer's shape at the scale the network's are
    (about unit variance), its bias and demodulation."""
    gen = torch.Generator(device=device).manual_seed(seed)
    side = geo.in_size + geo.kernel - 1
    x = torch.randn((batch, geo.out_channels, side, side), generator=gen, device=device) * 2
    bias = torch.randn((geo.out_channels,), generator=gen, device=device) * 0.2
    scale = torch.rand((batch, geo.out_channels), generator=gen, device=device) + 0.5
    return x, bias, scale


def run_f(geo, x, bias, scale):
    return filtered_lrelu(x, geo.up_filter, geo.down_filter, bias, geo.up, geo.down, geo.padding,
                          geo.gain, geo.slope, geo.clamp, scale=scale)


def run_twin(geo, x, bias, scale):
    return filtered_lrelu_plain(x, geo.up_filter, geo.down_filter, bias, geo.up, geo.down,
                                geo.padding, geo.gain, geo.slope, geo.clamp, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("geo", F_LAYERS, ids=lambda g: g.name)
def test_kernel_f_matches_its_twin_at_every_t1024_layer(cuda_device, geo):
    """F against the twin (the port's separable upfirdn2d, cuDNN's depthwise
    convolutions in fp32), batch 8, the twin run two rows at a time to keep
    its upsampled grid small. The two sum the same products in other
    orders, F with fused multiply-adds: within 2e-6 of the output's largest
    value, 1e-5 relative (fp32 rounding over 12 to 24 taps a pass)."""
    x, bias, scale = layer_inputs(geo, 8, cuda_device)
    before = K.LAUNCHES["filtered_lrelu"]
    with torch.inference_mode():
        got = run_f(geo, x, bias, scale)
    assert K.LAUNCHES["filtered_lrelu"] == before + 1
    with exact_fp32(), torch.inference_mode():
        want = torch.cat([
            filtered_lrelu_plain(x[i:i + 2], geo.up_filter, geo.down_filter, bias, geo.up,
                                 geo.down, geo.padding, geo.gain, geo.slope, geo.clamp,
                                 scale[i:i + 2]) for i in range(0, 8, 2)])
    torch.cuda.synchronize()
    assert got.shape == want.shape == (8, geo.out_channels, geo.out_size, geo.out_size)
    err = float((got - want).abs().max())
    print(f"{geo.name}: max |F - twin| {err:.3e} of {float(want.abs().max()):.3e}")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6 * float(want.abs().max()))


# (layer whose filters, pads and gains are used, input side, batch): F's
# schedule at its edges. A strip is at most 120 outputs wide and a segment's
# rows follow from the batch (more segments where few planes fill the card)
STRIP_EDGES = {
    "narrow_up2_b1": ("L0_36_512", 38, 1),  # a 36px plane, narrower than a strip
    "narrow_up2_b48": ("L0_36_512", 38, 48),
    "narrow_up4_b48": ("L2_52_512", 38, 48),
    "ragged_up2": ("L8_276_203", 133, 3),  # 131 outputs: 2 strips of 68, odd rows, scalar stores
    "ragged_up4": ("L7_276_323", 79, 2),  # 134 outputs: 2 strips of 68, 134 not a multiple of 4
    "wide_up4_b1": ("L10_1044_81", 534, 1),  # few planes: the rows split into segments
    "wide_up2_b1": ("L13_1024_32", 1046, 1),
    "mid_up2_b48": ("L6_148_512", 150, 48),
}


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False], ids=["scale", "no_scale"])
@pytest.mark.parametrize("edge", list(STRIP_EDGES))
def test_kernel_f_matches_its_twin_at_the_schedules_edges(cuda_device, edge, scaled):
    """F's column strips and row segments at their edges: planes narrower
    than a strip, widths and heights that no strip or segment divides, batch
    1 (segments) and 48, with and without the demodulation; against the
    twin under the 14-layer test's tolerance, the twin run two rows at a
    time."""
    name, side, batch = STRIP_EDGES[edge]
    geo = next(g for g in F_LAYERS if g.name == name)
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.randn((batch, geo.out_channels, side, side), generator=gen,
                    device=cuda_device) * 2
    bias = torch.randn((geo.out_channels,), generator=gen, device=cuda_device) * 0.2
    scale = (torch.rand((batch, geo.out_channels), generator=gen, device=cuda_device) + 0.5
             if scaled else None)
    with torch.inference_mode():
        got = run_f(geo, x, bias, scale)
    with exact_fp32(), torch.inference_mode():
        want = torch.cat([run_twin(geo, x[i:i + 2], bias, None if scale is None else
                                   scale[i:i + 2]) for i in range(0, batch, 2)])
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    print(f"{edge} {tuple(got.shape)}: max |F - twin| {err:.3e} of {float(want.abs().max()):.3e}")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6 * float(want.abs().max()))


@pytest.mark.gpu
def test_kernel_f_counts_the_lanes_of_its_strips(cuda_device):
    """Under a profiler the wrapper counts each launch of F by its strips'
    lanes: the 36px layer's planes two a warp, the 1044px layer's one."""
    from gance_tpu_torch.utils import profiling

    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            for name in ("L0_36_512", "L11_1044_51"):
                geo = next(g for g in F_LAYERS if g.name == name)
                run_f(geo, *layer_inputs(geo, 1, cuda_device))
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset()
    assert counts.get("ops.filtered_lrelu_fused") == 2
    assert counts.get("ops.filtered_lrelu_lanes16") == counts.get("ops.filtered_lrelu_lanes32") == 1


@pytest.mark.gpu
def test_kernel_f_refuses_what_it_cannot_take(cuda_device):
    geo = F_LAYERS[0]
    x, bias, scale = layer_inputs(geo, 2, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        run_f(geo, x.to(torch.bfloat16), bias, scale)
    with pytest.raises(ValueError, match="kernel F takes"):
        filtered_lrelu(x, geo.up_filter, geo.down_filter, bias, 2, 1, geo.padding, geo.gain,
                       geo.slope, geo.clamp)
    with pytest.raises(ValueError, match="kernel F takes"):
        filtered_lrelu(x, geo.up_filter[:6], geo.down_filter, bias, geo.up, geo.down,
                       geo.padding, geo.gain, geo.slope, geo.clamp)
    # under autograd too: F's Function runs the kernel, so it refuses alike
    x.requires_grad_(True)
    with pytest.raises(TypeError, match="float32"):
        run_f(geo, x.to(torch.bfloat16), bias, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [F_LAYERS[0], F_LAYERS[2], F_LAYERS[12]], ids=lambda g: g.name)
def test_kernel_f_runs_under_autograd_with_the_twins_gradient(cuda_device, geo):
    """Where a gradient may be asked for, F's `FilteredLrelu` launches the
    kernel in the forward (one launch, output bit for bit with the twin's,
    TF32 off) and its backward is the twin's vector-Jacobian product (no
    launch): x's, the bias's and the scale's gradients equal autograd
    through the twin on the card within 1e-5 of their scale (the same
    cuDNN calls, whose algorithms may sum in another order)."""
    x, bias, scale = layer_inputs(geo, 2, cuda_device, seed=3)
    probe = None
    got = []
    for route in (run_f, run_twin):
        inputs = [t.clone().requires_grad_(True) for t in (x, bias, scale)]
        before = K.LAUNCHES["filtered_lrelu"]
        with exact_fp32():
            y = route(geo, *inputs)
            if probe is None:
                probe = torch.randn_like(y)
            grads = torch.autograd.grad((y * probe).sum(), inputs)
        torch.cuda.synchronize()
        assert K.LAUNCHES["filtered_lrelu"] == before + (route is run_f)
        got.append((y.detach(), grads))
    (y, grads), (want_y, want_grads) = got
    assert torch.equal(y, want_y)
    for g, w in zip(grads, want_grads):
        assert float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def card_tree(seed, device):
    params = S.init_generator_params(seed, T1024)
    rng = np.random.RandomState(seed + 1)
    params["synthesis"]["input"]["affine"]["weight"] = (
        rng.standard_normal((4, 512)) * 0.2).astype(np.float32)
    for name, layer in params["synthesis"].items():
        if name != "input":
            layer["bias"] = (rng.standard_normal(layer["bias"].shape) * 0.2).astype(np.float32)
            layer["magnitude_ema"] = np.float32(np.exp(0.2 * rng.standard_normal()))
    params["mapping"]["w_avg"] = (rng.standard_normal(512) * 0.5).astype(np.float32)

    def tensors(tree):
        return {k: tensors(v) if isinstance(v, dict) else torch.tensor(np.asarray(v), device=device)
                for k, v in tree.items()}

    return tensors(params)


@pytest.mark.gpu
def test_port_frames_match_the_reference_at_1024px_on_the_card(cuda_device):
    """The port's uint8 frames (every F layer through kernel F, batch 8) and
    the plain reference's (fp32, TF32 off, unfused filters) on the card:
    values differ by at most one step, in under 0.1% of them (the cells'
    limit on px_off_share is 1e-3 at most)."""
    from port_bench.reference import stylegan3 as R
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    import dataclasses

    params = card_tree(5, cuda_device)
    net = SynthesisNetwork(params=params, config=T1024, truncation_psi=1.2, device=cuda_device)
    z = np.random.RandomState(6).standard_normal((8, 512)).astype(np.float32)
    before = K.LAUNCHES["filtered_lrelu"]
    got = net.images_from_vectors(z)
    assert K.LAUNCHES["filtered_lrelu"] == before + len(F_LAYERS)
    del net
    config = dict(dataclasses.asdict(T1024), truncation_psi=1.2)
    want = R.frames_from_z(params, torch.from_numpy(z).to(cuda_device), config).cpu().numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    share = float((diff > 0).mean())
    print(f"px_off_share {share:.3e}, max step {diff.max()}, "
          f"saturated {float(((want == 0) | (want == 255)).mean()):.3e}")
    assert got.shape == (8, 1024, 1024, 3) and diff.max() <= 1 and share < 1e-3
