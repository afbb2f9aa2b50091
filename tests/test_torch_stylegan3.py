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
from gance_tpu_torch.ops.filtered_lrelu import (  # noqa: E402
    filtered_lrelu, filtered_lrelu_plain, output_size)
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


# Kernel F's schedule (ops/cuda/csrc/filtered_lrelu.cu), emulated in numpy: a
# block is one warp of 32 lanes; LS of them (32, or 16 with two planes a warp)
# own a strip of output columns of a plane and walk down a segment of rows one
# input row a step; the strip's lane i makes u columns 8i..8i+7 and outputs
# 4i..4i+3 of the strip
F_LANES, F_UCOLS, F_DCOLS, F_WINDOW = 32, 8, 4, 6


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def f_schedule(side: int, batch: int, channels: int, up: int, down: int, pad: int,
               down_taps: int, slots: int):
    """The C host's choice, line for line: E; the lanes a strip (16 where
    that leaves fewer idle than 32); the strips and their width (a multiple
    of 4, the widest the lanes' u columns feed); and the segment's rows
    (even) with the fewest waves of `slots` resident warps times a segment's
    bodies of 6 steps."""
    e = (-pad - 1) % up

    def width_max(lanes):
        return ((lanes * F_UCOLS - down_taps - e) // down + 1) // 4 * 4

    lanes = 16 if _cdiv(side, width_max(16)) * 16 < _cdiv(side, width_max(32)) * 32 else 32
    strips = _cdiv(side, width_max(lanes))
    width = _cdiv(_cdiv(side, strips), 4) * 4
    warps_per_row = batch * _cdiv(channels, F_LANES // lanes) * strips
    best = None
    for segs in range(1, max(1, min(64, side // 2)) + 1):
        rows = _cdiv(_cdiv(side, segs), 2) * 2
        waves = _cdiv(warps_per_row * _cdiv(side, rows), slots)
        bodies = _cdiv(_cdiv(e + down * (rows - 1) + down_taps, up), F_WINDOW)
        cost = waves * (5 * bodies + 1)
        if best is None or cost < best[0]:
            best = (cost, rows)
    return e, lanes, strips, width, best[1]


def _swizzled(col: np.ndarray) -> np.ndarray:
    """A v row's float for column `col`: 16-byte chunks, chunk bit 0 flipped
    where chunk bit 3 is set."""
    chunk = col >> 2
    return ((chunk ^ ((chunk >> 3) & 1)) << 2) | (col & 3)


def _fma(a, b, c) -> np.ndarray:
    """fmaf to fp32 rounding: the float32 product is exact in float64."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def emulate_f(x, fu, fd, bias, up, down, padding, gain, slope, clamp, scale, slots):
    """Kernel F's walk, lane arrays at a time: the output and how often each
    output was written."""
    b, c, h, w = x.shape
    tu, td = len(fu), len(fd)
    mu, pad = tu // up, padding[0]
    side = output_size(h, up, down, padding, tu, td)
    ku = (np.asarray(fu, np.float32)[::-1] * np.float32(up)).astype(np.float32)
    kd = np.asarray(fd, np.float32)[::-1].copy()
    e, ls, strips, width, rows = f_schedule(side, b, c, up, down, pad, td, slots)
    groups = F_UCOLS // up
    read = 12 if up == 2 else 8  # float4 or float2 loads of the 8 / up + 5 inputs
    nt = groups * (ls - 1) + read
    chunks = _cdiv(e + down * (F_DCOLS - 1) + td, 4)
    lanes = np.arange(ls)
    out = np.full((b, c, side, side), np.nan, np.float32)
    writes = np.zeros(out.shape, np.int64)
    x, bias = x.numpy(), bias.numpy()
    scale = np.ones((b, c), np.float32) if scale is None else scale.numpy()
    for bi, ci, seg, strip in np.ndindex(b, c, _cdiv(side, rows), strips):
        # the warp's lane of each of the strip's lanes: the planes a warp
        # walks lie side by side in its v rows
        warp_lanes = ci % (F_LANES // ls) * ls + lanes
        ox0, oy0 = strip * width, seg * rows
        nr = min(rows, side - oy0)
        # the strip's u columns and the segment's v rows start E before its
        # first output, on phase 1 of up
        assert (down * ox0 - e - pad - 1) % up == 0 and (down * oy0 - e - pad - 1) % up == 0
        tx0 = (down * ox0 - e - pad - 1) // up + 1
        ty0 = (down * oy0 - e - pad - 1) // up + 1

        def t_row(r):
            q = tx0 + np.arange(nt)
            inside = (q >= 0) & (q < w) & (0 <= r < h)
            row = np.zeros(nt, np.float32)
            if inside.any():
                xs = (x[bi, ci, r, q[inside]] * scale[bi, ci]).astype(np.float32)
                row[inside] = xs + bias[ci]
            return row

        def x_up(row):
            ux = np.empty((ls, F_UCOLS), np.float32)
            for g, j in np.ndindex(groups, up):
                k0 = up - 1 - j if j < up - 1 else 0
                acc = np.zeros(ls, np.float32)
                for m in range(mu):
                    acc = _fma(row[groups * lanes + g + m], ku[k0 + up * m], acc)
                ux[:, up * g + j] = acc
            return ux

        window = np.zeros((F_WINDOW, ls, F_UCOLS), np.float32)  # slot: row mod 6
        for k in range(F_WINDOW - 1):
            window[k] = x_up(t_row(ty0 + k))
        flight = np.zeros((td // down, ls, F_DCOLS), np.float32)  # slot: output mod 6
        bodies = _cdiv(_cdiv(e + down * (nr - 1) + td, up), F_WINDOW)
        for body, st in np.ndindex(bodies, F_WINDOW):
            step = F_WINDOW * body + st
            window[(F_WINDOW - 1 + st) % F_WINDOW] = x_up(t_row(ty0 + F_WINDOW - 1 + step))
            v_rows = np.full((up, F_LANES * F_UCOLS + 32), np.nan, np.float32)
            for j in range(up):
                k0 = up - 1 - j if j < up - 1 else 0
                acc = np.zeros((ls, F_UCOLS), np.float32)
                for m in range(mu):
                    acc = _fma(window[(st + m) % F_WINDOW], ku[k0 + up * m], acc)
                v = np.maximum(acc, (acc * np.float32(slope)).astype(np.float32))
                v = (v * np.float32(gain)).astype(np.float32)
                v = np.minimum(np.maximum(v, np.float32(-clamp)), np.float32(clamp))
                v_rows[j, _swizzled(F_UCOLS * warp_lanes[:, None] + np.arange(F_UCOLS))] = v
            for j in range(up):
                big_l = up * step + j  # the segment's v row
                cols = 2 * F_DCOLS * warp_lanes[:, None] + np.arange(4 * chunks)
                got = v_rows[j, _swizzled(cols)]
                dx = np.empty((ls, F_DCOLS), np.float32)
                for o in range(F_DCOLS):
                    acc = np.zeros(ls, np.float32)
                    for m in range(td):
                        acc = _fma(got[:, e + down * o + m], kd[m], acc)
                    dx[:, o] = acc
                lm = (big_l - e) % (down * len(flight))
                assert lm == (up * st + j - e) % (down * len(flight))  # static in the body
                for i in range(len(flight)):
                    m = lm % down + down * i
                    lo = (big_l - e - m) // down  # the output row it feeds
                    slot = ((lm - m) // down) % len(flight)
                    assert slot == lo % len(flight)
                    flight[slot] = _fma(dx, kd[m], 0.0 if m == 0 else flight[slot])
                    if m == td - 1 and 0 <= lo < nr:
                        ox = ox0 + F_DCOLS * lanes[:, None] + np.arange(F_DCOLS)
                        keep = (ox - ox0 < width) & (ox < side)
                        out[bi, ci, oy0 + lo, ox[keep]] = flight[slot][keep]
                        writes[bi, ci, oy0 + lo, ox[keep]] += 1
    return torch.from_numpy(out), writes


# (layer whose filters and gains are used, its pads or others, input side,
# channels, resident warps): every E of both (up, down) cases, planes
# narrower than a strip, strips of 32 lanes and of 16 (two planes a warp, the
# second idle where the channels are odd), sides that no strip width, 4 or
# segment divides, one segment or many
F_SCHEDULES = {
    "up2_narrow": ("L0_36_512", None, 38, 3, 12),
    "up2_two_warp_strips": ("L0_36_512", None, 202, 1, 4),
    "up2_half_strips_segments": ("L0_36_512", None, 131, 3, 10**6),
    "up2_e1": ("L0_36_512", (8, 9), 61, 2, 10**6),
    "critical": ("L13_1024_32", None, 40, 3, 1),
    "up4_narrow": ("L2_52_512", None, 38, 3, 12),
    "up4_e0": ("L2_52_512", (-5, -10), 70, 2, 10**6),
    "up4_e2_ragged": ("L2_52_512", (-7, -8), 73, 3, 3),
    "up4_e3": ("L2_52_512", (-8, -7), 70, 1, 10**6),
}


@pytest.mark.parametrize("scaled", [True, False], ids=["scale", "no_scale"])
@pytest.mark.parametrize("case", list(F_SCHEDULES))
def test_kernel_f_schedule_reproduces_the_twin_and_writes_each_output_once(case, scaled):
    """Kernel F's index map in numpy (strips, segments, the window and
    output slots, the swizzled v rows, the x halo's offsets), lane by lane:
    it gives the twin's output to fp32 rounding (its fmaf in float64) and
    writes every output exactly once."""
    name, pads, side, channels, slots = F_SCHEDULES[case]
    geo = next(g for g in S.synthesis_geometry(T1024)[1] if g.name == name)
    padding = pads or geo.padding
    gen = torch.Generator().manual_seed(19)
    x = torch.randn((1, channels, side, side), generator=gen) * 2
    bias = torch.randn((channels,), generator=gen) * 0.2
    scale = torch.rand((1, channels), generator=gen) + 0.5 if scaled else None
    call = (geo.up_filter, geo.down_filter, bias, geo.up, geo.down, padding, geo.gain, geo.slope,
            geo.clamp)
    got, writes = emulate_f(x, *call, scale, slots)
    want = filtered_lrelu_plain(x, *call, scale)
    assert got.shape == want.shape and (writes == 1).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_kernel_f_schedule_fits_lanes_and_rows_to_the_layer():
    """On an H100 (132 SMs of 16 resident warps) at the 1024px network's
    shapes: the 1044px layers take 9 strips of 116 outputs a warp, the
    narrow ones two planes a warp (16 lanes a strip); at batch 1 the last
    layer's 288 warps split its rows into segments that fill the card."""
    slots = 132 * 16
    assert f_schedule(1044, 8, 81, 4, 2, -6, 12, slots)[:4] == (1, 32, 9, 116)
    assert f_schedule(36, 8, 512, 2, 2, 9, 12, slots)[:4] == (0, 16, 1, 36)
    assert f_schedule(148, 8, 512, 4, 2, -6, 12, slots)[:4] == (1, 16, 3, 52)
    rows = f_schedule(1024, 1, 32, 2, 2, -11, 12, slots)[4]
    assert rows % 2 == 0 and 6 <= -(-1024 // rows) and 288 * -(-1024 // rows) <= slots


def test_kernel_f_wrapper_counts_the_lanes_the_kernel_picks():
    """The wrapper's `strip_lanes`, which names the counter of each launch,
    is the C host's rule as the schedule above emulates it, at every side up
    to 1100 and every E of both (up, down) cases."""
    from gance_tpu_torch.ops.filtered_lrelu import strip_lanes

    for up, pad in ((2, 9), (2, 8), (4, -6), (4, -5), (4, -7), (4, -8)):
        for side in range(1, 1101):
            assert strip_lanes(side, up, 2, pad, 12) == f_schedule(side, 1, 1, up, 2, pad, 12,
                                                                   1)[1]


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
