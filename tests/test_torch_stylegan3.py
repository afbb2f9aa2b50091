"""
StyleGAN3-T in the port (models/stylegan3.py, ops/filtered_lrelu.py) against
the plain reference (port_bench/reference/stylegan3.py, the benchmark's) and
NVlabs' published network, on the CPU: the 1024px network's geometry and
filters, the twin of kernel F and its autograd Function, the whole generator
at a small size through the model, the runtime's stream and the serving
batcher, and the parameter tree's names.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gance_tpu_torch.models import stylegan3 as S  # noqa: E402
from gance_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain  # noqa: E402
from port_bench.reference import stylegan3 as R  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

T1024 = S.StyleGAN3Config()
# every kind of layer (up 2 and 4, the critically sampled crop, ToRGB) at 64px
SMALL = S.StyleGAN3Config(resolution=64, num_layers=6, channel_base=2048, channel_max=64)
TINY = S.StyleGAN3Config(resolution=32, num_layers=6, channel_base=1024, channel_max=32)
PSI = 1.2

# NVlabs' stylegan3-t-ffhq-1024x1024: layer name -> (up, down, up taps, down taps, pads)
PUBLISHED = {
    "L0_36_512": (2, 2, 12, 12, (9, 8)),
    "L1_36_512": (2, 2, 12, 12, (9, 8)),
    "L2_52_512": (4, 2, 24, 12, (-6, -9)),
    "L3_52_512": (2, 2, 12, 12, (9, 8)),
    "L4_84_512": (4, 2, 24, 12, (-6, -9)),
    "L5_148_512": (4, 2, 24, 12, (-6, -9)),
    "L6_148_512": (2, 2, 12, 12, (9, 8)),
    "L7_276_323": (4, 2, 24, 12, (-6, -9)),
    "L8_276_203": (2, 2, 12, 12, (9, 8)),
    "L9_532_128": (4, 2, 24, 12, (-6, -9)),
    "L10_1044_81": (4, 2, 24, 12, (-6, -9)),
    "L11_1044_51": (2, 2, 12, 12, (9, 8)),
    "L12_1044_32": (2, 2, 12, 12, (9, 8)),
    "L13_1024_32": (2, 2, 12, 12, (-11, -12)),
    "L14_1024_3": (1, 1, 1, 1, (0, 0)),
}


def reference_config(config: S.StyleGAN3Config) -> dict:
    return dict(dataclasses.asdict(config), truncation_psi=PSI)


def fabricated(seed: int, config: S.StyleGAN3Config) -> dict:
    """A tree as tensors with every term of the equations moving the frames:
    NVlabs' init with biases, the input's affine, magnitude_ema and w_avg
    drawn away from their initial values."""
    params = S.init_generator_params(seed, config)
    rng = np.random.RandomState(seed + 1)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params["synthesis"]["input"]["affine"]["weight"] = normal((4, config.dlatent_size), 0.2)
    for name, layer in params["synthesis"].items():
        if name != "input":
            layer["bias"] = normal(layer["bias"].shape, 0.2)
            layer["magnitude_ema"] = np.float32(np.exp(0.3 * rng.standard_normal()))
            layer["affine"]["bias"] = 1 + normal(layer["affine"]["bias"].shape, 0.2)
    for i in range(config.mapping_layers):
        params["mapping"][f"fc{i}"]["bias"] = normal((config.dlatent_size,), 20.0)
    params["mapping"]["w_avg"] = normal((config.dlatent_size,), 0.5)

    def tensors(tree):
        return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
                for k, v in tree.items()}

    return tensors(params)


def z_rows(count: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((count, 512)).astype(np.float32)


def test_geometry_of_t1024_is_the_published_network():
    inp, layers = S.synthesis_geometry(T1024)
    assert (inp.channels, inp.size, inp.sampling_rate, inp.bandwidth) == (512, 36, 16.0, 2.0)
    assert {g.name: (g.up, g.down, g.up_taps, g.down_taps, g.padding) for g in layers} == PUBLISHED
    assert list(PUBLISHED) == [g.name for g in layers]  # in order
    assert T1024.num_style_rows == 16
    for geo, spec in zip(layers, R.layers_of(reference_config(T1024))):
        assert (geo.name, geo.up, geo.down, geo.padding) == (spec["name"], spec["up"],
                                                             spec["down"], spec["padding"])
    # the last layers: critically sampled at 1024 (cutoff = half the rate), then ToRGB
    assert layers[12].out_cutoff == layers[13].out_cutoff == 512.0
    assert layers[14].is_torgb and layers[14].gain == 1.0 and layers[14].slope == 1.0


@pytest.mark.parametrize("name", list(PUBLISHED)[:-1])
def test_filter_design_equals_scipy_firwin(name):
    signal = pytest.importorskip("scipy.signal")
    geo = next(g for g in S.synthesis_geometry(T1024)[1] if g.name == name)
    tmp = max(geo.in_sampling_rate, geo.out_sampling_rate) * 2
    want_up = signal.firwin(geo.up_taps, geo.in_cutoff, width=2 * geo.in_half_width, fs=tmp)
    want_down = signal.firwin(geo.down_taps, geo.out_cutoff, width=2 * geo.out_half_width, fs=tmp)
    np.testing.assert_allclose(geo.up_filter, want_up, rtol=0, atol=1e-7)
    np.testing.assert_allclose(geo.down_filter, want_down, rtol=0, atol=1e-7)
    spec = next(s for s in R.layers_of(reference_config(T1024)) if s["name"] == name)
    np.testing.assert_allclose(spec["fu"], want_up, rtol=0, atol=1e-7)
    np.testing.assert_allclose(spec["fd"], want_down, rtol=0, atol=1e-7)


CASES = {  # one layer of T-1024 for every (up, down, taps, pads) it has
    "up2": "L0_36_512", "up4": "L2_52_512", "critical": "L13_1024_32", "torgb": "L14_1024_3"}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_equals_the_reference_filtered_lrelu(case):
    """F's twin (the port's separable upfirdn2d and bias_act) against the
    reference's unfused one (zero-stuff, pad, 1-D convs) on a 40-sided
    plane with the layer's own filters, pads and gains. The two sum the
    same products per axis in the same order; 1e-6 of the values' scale is
    fp32 rounding."""
    geo = next(g for g in S.synthesis_geometry(T1024)[1] if g.name == CASES[case])
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 3, 40, 40), generator=gen) * 3
    bias = torch.randn((3,), generator=gen)
    scale = torch.rand((2, 3), generator=gen) + 0.5
    got = filtered_lrelu(x, geo.up_filter, geo.down_filter, bias, geo.up, geo.down, geo.padding,
                         geo.gain, geo.slope, geo.clamp, scale=scale)
    fu = None if geo.up_filter is None else np.asarray(geo.up_filter)
    fd = None if geo.down_filter is None else np.asarray(geo.down_filter)
    want = R.filtered_lrelu(x * scale[:, :, None, None], fu, fd, bias, geo.up, geo.down,
                            geo.padding, geo.gain, geo.slope, geo.clamp)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    torch.testing.assert_close(
        filtered_lrelu_plain(x, geo.up_filter, geo.down_filter, bias, geo.up, geo.down,
                             geo.padding, geo.gain, geo.slope, geo.clamp, scale), got)
    # clamping is part of it: a large input saturates at the clamp before the
    # down filter, which can overshoot it by at most its absolute sum squared
    big = filtered_lrelu(x * 1e4, geo.up_filter, geo.down_filter, bias, geo.up, geo.down,
                         geo.padding, geo.gain, geo.slope, 256.0)
    want = R.filtered_lrelu(x * 1e4, fu, fd, bias, geo.up, geo.down, geo.padding, geo.gain,
                            geo.slope, 256.0)
    torch.testing.assert_close(big, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    overshoot = 1.0 if fd is None else float(np.abs(fd).sum()) ** 2
    assert 100 < float(big.abs().max()) <= 256.0 * overshoot * (1 + 1e-5)


@pytest.mark.parametrize("scaled", [False, True], ids=["no_scale", "scale"])
@pytest.mark.parametrize("case", ["up2", "up4", "critical"])
def test_filtered_lrelu_function_gradients_are_the_twins(case, scaled):
    """Where a gradient may be asked for, the wrapper goes through
    `FilteredLrelu` (F's forward on the card, the twin's here), whose
    backward is the twin's vector-Jacobian product: its output and its first
    and second order gradients equal autograd through the twin itself, bit
    for bit, and a forward counts one twin call, the backward none."""
    from gance_tpu_torch.ops.filtered_lrelu import FilteredLrelu
    from gance_tpu_torch.utils import profiling

    geo = next(g for g in S.synthesis_geometry(T1024)[1] if g.name == CASES[case])
    gen = torch.Generator().manual_seed(11)
    x0 = torch.randn((2, 3, 24, 24), generator=gen) * 3
    bias0 = torch.randn((3,), generator=gen)
    scale0 = torch.rand((2, 3), generator=gen) + 0.5 if scaled else None
    probe = None
    results = []
    for route in (filtered_lrelu, filtered_lrelu_plain):
        x, bias = x0.clone().requires_grad_(True), bias0.clone().requires_grad_(True)
        scale = None if scale0 is None else scale0.clone().requires_grad_(True)
        inputs = [t for t in (x, bias, scale) if t is not None]
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            y = route(x, geo.up_filter, geo.down_filter, bias, geo.up, geo.down, geo.padding,
                      geo.gain, geo.slope, geo.clamp, scale=scale)
            if probe is None:
                probe = torch.randn(y.shape, generator=gen)
            first = torch.autograd.grad((y * probe).sum(), inputs, create_graph=True)
            second = torch.autograd.grad(sum(g.square().sum() for g in first), inputs,
                                         allow_unused=True, materialize_grads=True)
        counts = profiling.counters()
        profiling.reset()
        results.append((y, first, second, counts, y.grad_fn))
    (y, first, second, counts, fn), (want_y, want_first, want_second, plain_counts, _) = results
    assert type(fn).__name__ == FilteredLrelu.__name__ + "Backward"
    assert counts.get("ops.filtered_lrelu_twin") == 1 and not counts.get("ops.filtered_lrelu_fused")
    assert not plain_counts
    assert torch.equal(y, want_y)
    for got, want in zip(first + second, want_first + want_second):
        assert torch.equal(got, want)
    # the leaky ReLU is linear between its kinks: the second order comes
    # through the scale, which multiplies x
    assert (float(second[0].abs().sum()) > 0) == scaled


def test_generator_matches_the_reference_at_64px():
    """Float frames of the whole generator (mapping, truncation, the Fourier
    input, 6 layers, ToRGB) within 2e-5 of the reference's, which sums in
    other orders (NVlabs' per-sample modulated weights in one grouped conv,
    the style's mean over the batch): fp32 rounding, about 1e-6 observed, in
    frames of about 0.2 standard deviation. uint8 frames differ by at most
    one step, in under 0.1% of the values."""
    params = fabricated(11, SMALL)
    z = torch.from_numpy(z_rows(4, 12))
    got = S.generator_apply(params, z, SMALL, truncation_psi=PSI)
    want = R.images_from_z(params, z, reference_config(SMALL), block=4).permute(0, 2, 3, 1)
    assert got.shape == (4, 64, 64, 3)
    assert float(want.std()) > 0.05
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    frames = S.generator_apply(params, z, SMALL, truncation_psi=PSI, uint8_output=True)
    reference = R.frames_from_z(params, z, reference_config(SMALL), block=4)
    diff = (frames.int() - reference.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    # another network does not pass
    other = R.frames_from_z(fabricated(13, SMALL), z, reference_config(SMALL), block=4)
    assert float((frames != other).float().mean()) > 0.5


def test_runtime_renders_sg3_through_its_normal_path():
    """SynthesisNetwork's vectors and matrices paths and
    MultiNetwork.synthesize_stream over two networks give the reference's
    uint8 frames; a frame does not depend on the rows batched with it."""
    from gance_tpu_torch.synthesis.runtime import MultiNetwork, SynthesisNetwork

    trees = [fabricated(21, TINY), fabricated(22, TINY)]
    nets = [SynthesisNetwork(params=t, config=TINY, truncation_psi=PSI, device="cpu")
            for t in trees]
    z = z_rows(6, 23)
    config = reference_config(TINY)
    want = [R.frames_from_z(t, torch.from_numpy(z), config, block=6).numpy() for t in trees]

    def close(got, ref):
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert got.shape == ref.shape and diff.max() <= 1 and (diff > 0).mean() < 2e-3

    close(nets[0].images_from_vectors(z), want[0])
    assert np.array_equal(nets[0].images_from_vectors(z[2:3])[0],
                          nets[0].images_from_vectors(z)[2])
    ws = R.dlatents_from_z(trees[1], torch.from_numpy(z), config).numpy()
    assert ws.shape == (6, TINY.num_style_rows, 512)
    close(nets[1].images_from_matrices(ws), want[1])
    indices = np.array([0, 0, 1, 0, 1, 1])
    stream = MultiNetwork.from_networks(nets).synthesize_all(z, indices, batch_size=2,
                                                             lookahead=2)
    close(stream, np.stack([want[k][i] for i, k in enumerate(indices)]))


def test_dynamic_batcher_serves_an_sg3_network():
    from gance_tpu_torch.serving.batcher import DynamicBatcher
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    net = SynthesisNetwork(params=fabricated(31, TINY), config=TINY, truncation_psi=PSI,
                           device="cpu")
    z = z_rows(3, 32)
    with DynamicBatcher(net, max_batch=8, max_delay_ms=0) as batcher:
        got = batcher.submit(z).result(timeout=120)
    assert got.dtype == np.uint8 and got.shape == (3, 32, 32, 3)
    assert np.array_equal(got, net.images_from_vectors(z))


def test_tree_keys_are_the_official_state_dict_names():
    """The fabricated tree of T-1024, flattened at the dots, holds the
    published generator's state_dict names and shapes, but for the filter
    buffers (up_filter, down_filter), which the port derives from the
    config."""
    tree = S.init_generator_params(0, T1024)

    def flat(node, prefix=""):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", tuple(np.shape(value))

    names = dict(flat(tree))
    want = {"mapping.fc0.weight": (512, 512), "mapping.fc0.bias": (512,),
            "mapping.fc1.weight": (512, 512), "mapping.fc1.bias": (512,),
            "mapping.w_avg": (512,), "synthesis.input.weight": (512, 512),
            "synthesis.input.affine.weight": (4, 512), "synthesis.input.affine.bias": (4,),
            "synthesis.input.transform": (3, 3), "synthesis.input.freqs": (512, 2),
            "synthesis.input.phases": (512,)}
    cin = 512
    for name in PUBLISHED:
        cout, k = int(name.split("_")[2]), 1 if name == "L14_1024_3" else 3
        want.update({f"synthesis.{name}.weight": (cout, cin, k, k),
                     f"synthesis.{name}.bias": (cout,),
                     f"synthesis.{name}.magnitude_ema": (),
                     f"synthesis.{name}.affine.weight": (cin, 512),
                     f"synthesis.{name}.affine.bias": (cin,)})
        cin = cout
    assert names == want
    freqs = tree["synthesis"]["input"]["freqs"]
    assert np.linalg.norm(freqs, axis=1).max() < 2 * T1024.first_cutoff


def test_sg3_gradients_flow_through_the_twin_and_fp32_is_required():
    params = fabricated(41, TINY)
    ws = torch.randn((1, TINY.num_style_rows, 512), requires_grad=True)
    S.synthesis_apply(params, ws, TINY).square().mean().backward()
    assert ws.grad is not None and torch.isfinite(ws.grad).all() and ws.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="float32"):
        S.synthesis_apply(params, ws.detach(), TINY, compute_dtype=torch.bfloat16)
