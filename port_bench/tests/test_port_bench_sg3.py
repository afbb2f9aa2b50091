"""
The StyleGAN3-T cell's harness on the CPU at a small size (32px, 6 layers,
narrow channels; every kind of layer is there): the kind `render_stylegan3`
runs and comes out correct, and comes out not correct with an altered frame,
frames from the wrong network, or kernel F's filters left out; the weights,
the reference and the counts of operations; the cell's metrics read from
hand-made contexts. Run with `python -m pytest port_bench/tests -q`.
"""

import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_bench.harness import device as dev
from port_bench.harness import manifest, traffic, weights_sg3
from port_bench.harness.trace import DeviceTrace
from port_bench.reference import bounds_sg3, opcount_sg3
from port_bench.reference import stylegan3 as reference
from gance_tpu_torch.utils import profiling

dev.program_environment()
torch.set_num_threads(4)
SEED = 2**31 + 23023
CELL = "sg3t1024-render"
CONFIG = json.loads((manifest.BENCH_DIR / "configs" / "stylegan3-t-1024.json").read_text())
SMALL = dict(resolution=32, num_layers=6, channel_base=1024, channel_max=32)


def small_cell(max_frames_per_s: int) -> manifest.Cell:
    cell = manifest.load_cell(CELL)
    cell.config.update(SMALL)
    cell.traffic.update(max_frames_per_s=max_frames_per_s)
    return cell


def run(seconds: float = 2.0, max_frames_per_s: int = 200) -> dict:
    from port_bench.run import run_cell

    return run_cell(small_cell(max_frames_per_s), SEED, seconds, False, "cpu",
                    process_start=time.perf_counter())


def read(name, ctx):
    return manifest.layer_metric_reader(name).read(ctx)


def test_sg3_render_run_on_the_cpu_is_correct():
    line = run()
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_per_s"]["value"] > 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}


def test_traced_sg3_render_run_on_the_cpu_reads_its_metrics():
    """A traced run: the render stream's runtime metrics read the spans and
    counters of the stream this cell drives (no device share on the CPU,
    which runs no device operation), and every filtered leaky ReLU of the
    window ran the twin here, so F's share reads 0."""
    from port_bench.run import run_cell

    profiling.reset()
    line = run_cell(small_cell(200), SEED, 2.0, True, "cpu", process_start=time.perf_counter())
    assert line["correct"], line["checks"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["dispatch_ms_per_frame.render"] > 0
    assert 0 <= metrics["pad_row_share.render"] < 100
    assert metrics["filtered_lrelu_fused_share.sg3"] == 0.0
    assert metrics["synthesis_mfu.sg3"] > 0
    assert not {"device_idle_share.render", "idle_in_dispatch_share.render",
                "filtered_lrelu_roofline.sg3"} & set(metrics)
    counts = profiling.counters()
    layers = len(bounds_sg3.f_layers(dict(CONFIG, **SMALL)))  # every layer but ToRGB
    assert layers == SMALL["num_layers"]
    assert counts["ops.filtered_lrelu_twin"] == layers * counts["runtime.forwards"] > 0
    profiling.reset()


def test_sg3_render_with_an_altered_frame_is_not_correct(monkeypatch):
    """The uint8 epilogue adds one step to every value of a batch's first frame."""
    import gance_tpu_torch.models.stylegan3 as model

    plain = model.images_to_uint8

    def altered(images, *args, **kwargs):
        out = plain(images, *args, **kwargs).clone()
        out[0] = out[0] + 1
        return out

    monkeypatch.setattr(model, "images_to_uint8", altered)
    assert not run()["correct"]


def test_sg3_render_with_frames_from_the_wrong_network_is_not_correct(monkeypatch):
    from gance_tpu_torch.synthesis.runtime import MultiNetwork

    plain = MultiNetwork.synthesize_stream

    def swapped(self, frame_data, network_indices=None, *args, **kwargs):
        return plain(self, frame_data, 1 - np.asarray(network_indices), *args, **kwargs)

    monkeypatch.setattr(MultiNetwork, "synthesize_stream", swapped)
    assert not run()["correct"]


def test_sg3_render_without_the_filters_is_not_correct(monkeypatch):
    """Kernel F replaced by an unfiltered bias + leaky ReLU + clamp, resampled
    to the output's side by taking the nearest sample: the shapes pass, the
    mathematics of the filters is left out."""
    import gance_tpu_torch.models.stylegan3 as model
    from gance_tpu_torch.ops.filtered_lrelu import output_size

    def unfiltered(x, fu, fd, bias, up, down, padding, gain, slope, clamp, scale=None):
        if scale is not None:
            x = x * scale[:, :, None, None]
        x = x + bias[None, :, None, None]
        x = (torch.maximum(x, x * slope) * gain).clamp(-clamp, clamp)
        side = output_size(x.shape[-1], up, down, padding, len(fu), len(fd))
        return F.interpolate(x, size=(side, side), mode="nearest")

    monkeypatch.setattr(model, "filtered_lrelu", unfiltered)
    line = run(max_frames_per_s=2000)
    assert not line["correct"]
    assert line["checks"]["px_off_share"]["value"] > 0.1


def test_a_program_without_stylegan3_fails_at_once(monkeypatch):
    """The parent of the change that adds StyleGAN3 has no
    models/stylegan3.py: the kind raises before it builds or draws anything."""
    monkeypatch.setitem(sys.modules, "gance_tpu_torch.models.stylegan3", None)
    started = time.perf_counter()
    with pytest.raises(ImportError):
        run()
    assert time.perf_counter() - started < 5


def test_weights_are_the_official_tree_and_repeat_per_seed():
    from gance_tpu_torch.models.stylegan3 import StyleGAN3Config, init_generator_params

    def names(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out.update(names(value, f"{prefix}{key}."))
            else:
                out[f"{prefix}{key}"] = tuple(value.shape)
        return out

    config = dict(CONFIG, **SMALL)
    a = weights_sg3.generator_params(config, SEED, "cpu")
    program_tree = init_generator_params(0, StyleGAN3Config(**SMALL))
    assert names(a) == names(program_tree)
    b = weights_sg3.generator_params(config, SEED, "cpu")
    c = weights_sg3.generator_params(config, SEED, "cpu", stream=1)
    layer = reference.layers_of(config)[3]["name"]
    assert torch.equal(a["synthesis"][layer]["weight"], b["synthesis"][layer]["weight"])
    assert not torch.equal(a["synthesis"][layer]["weight"], c["synthesis"][layer]["weight"])
    phases = a["synthesis"]["input"]["phases"]
    assert float(phases.min()) >= -0.5 and float(phases.max()) < 0.5
    magnitudes = torch.stack([a["synthesis"][s["name"]]["magnitude_ema"]
                              for s in reference.layers_of(config)])
    assert float(magnitudes.min()) > 0 and float(magnitudes.std()) > 0


def test_the_reference_follows_the_port():
    from port_bench.kinds.render_stylegan3 import generator_config
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    config = dict(CONFIG, **SMALL)
    params = weights_sg3.generator_params(config, SEED, "cpu")
    net = SynthesisNetwork(params=params, config=generator_config(config), truncation_psi=1.2,
                           device="cpu")
    z = traffic.z_rows(4, 512, SEED)
    got = net.images_from_vectors(z)
    want = reference.frames_from_z(params, torch.from_numpy(z), config).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert ((want == 0) | (want == 255)).mean() < 0.05  # the frames are not saturated


def test_operation_counts_match_the_published_shapes():
    assert round(opcount_sg3.conv_macs(CONFIG) / 1e9, 1) == CONFIG["conv_gmac_per_frame"] == 285.1
    assert round(opcount_sg3.filter_macs(CONFIG) / 1e9, 1) == 22.3
    assert len(bounds_sg3.forward_launches(CONFIG, 8)) == 14
    l10 = next(s for s in bounds_sg3.f_layers(CONFIG) if s["name"] == "L10_1044_81")
    assert bounds_sg3.f_bytes(l10, 1) == 4 * (81 * 534 ** 2 + 81 + 81 * 1044 ** 2)
    # operations and bytes bound F about equally: operations at up 4, bytes
    # at most layers of up 2
    for spec in bounds_sg3.f_layers(CONFIG):
        ratio = (2 * bounds_sg3.f_macs(spec, 1) / 67e12) / (bounds_sg3.f_bytes(spec, 1) / 3.35e12)
        assert 0.85 < ratio < 1.4 and (ratio > 1) == (spec["up"] == 4 or spec["in_size"] == 36)


def test_sg3_metrics_on_hand_made_contexts():
    rows = [8, 8, 4]
    bounds = [s for r in rows for _, s in bounds_sg3.forward_launches(CONFIG, r)]
    kernels = [(f"void (anonymous namespace)::filtered_lrelu_kernel<2, 2>(float const*)",
                float(i), 2.0 * b * 1e6) for i, b in enumerate(bounds)]
    trace = DeviceTrace(window=(0.0, 1e7), device_ops=kernels + [("other_kernel", 0.0, 5.0)])
    ctx = SimpleNamespace(trace=trace, forward_rows=rows, config=CONFIG, frames=20, window_s=2.0)
    assert read("filtered_lrelu_roofline.sg3", ctx) == pytest.approx(50.0)
    # one launch more or less than the forwards make: left out
    short = SimpleNamespace(**dict(vars(ctx), trace=DeviceTrace(window=(0.0, 1e7),
                                                                device_ops=kernels[1:])))
    assert read("filtered_lrelu_roofline.sg3", short) is None
    assert read("filtered_lrelu_roofline.sg3", SimpleNamespace(trace=None, forward_rows=rows,
                                                               config=CONFIG)) is None
    want = 100 * 2 * (285.1226e9 + 0.1007e9 + 22.316e9) * 20 / 2.0 / 67e12
    assert read("synthesis_mfu.sg3", ctx) == pytest.approx(want, rel=1e-4)

    profiling.reset()
    assert read("filtered_lrelu_fused_share.sg3", SimpleNamespace()) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("ops.filtered_lrelu_fused", 42)
        profiling.count("ops.filtered_lrelu_twin", 14)
    assert read("filtered_lrelu_fused_share.sg3", SimpleNamespace()) == pytest.approx(75.0)
    profiling.reset()


def test_the_cell_is_in_the_manifest_as_the_issue_gives_it():
    m = manifest.load_manifest()
    cell = next(w for w in m["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "stylegan3-t-1024", "render-switching-sg3", 1)
    config = next(c for c in m["configs"] if c["name"] == "stylegan3-t-1024")
    assert config["reduced"] == [] and CONFIG["num_layers"] == 14
    assert (CONFIG["channel_base"], CONFIG["channel_max"], CONFIG["mapping_layers"]) == (
        32768, 512, 2)
    mix = manifest.traffic_file("render-switching-sg3")
    plain = manifest.traffic_file("render-switching")
    assert {k: v for k, v in mix.items() if k not in ("kind", "why")} == \
        {k: v for k, v in plain.items() if k not in ("kind", "why")}
    resolved = manifest.load_cell(CELL)
    assert {m["name"] for m in resolved.end_to_end} == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in resolved.per_layer} == {
        "filtered_lrelu_roofline.sg3", "filtered_lrelu_fused_share.sg3", "synthesis_mfu.sg3",
        # the render stream's runtime metrics, which read the spans and
        # counters of `synthesize_stream` that this cell drives as the others
        "device_idle_share.render", "idle_in_dispatch_share.render",
        "dispatch_ms_per_frame.render", "pad_row_share.render"}
