"""
The port's one-shot quick looks and worked examples (gance_tpu_torch/viz/
one_shot.py, examples.py) against gance_tpu's, on the CPU. The scatter
halves and the demos that take no network are held pixel for pixel; the
synthesized halves, from a network built from gance_tpu's params carried by
`models/convert.py`, within 1 uint8 step on at least 99.9% of values.
`blog_media_demo` and `quick_look_demo` build their own random network on
each side (the port's draws are not JAX's threefry), so they are compared
through their `network` argument, with that carried network. Videos are
written with GANCE_TPU_EGRESS=raw-spill and read back.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
pytest.importorskip("cv2")

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from gance_tpu import types as jax_types  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.synthesis.runtime import SynthesisNetwork as JaxSynthesisNetwork  # noqa: E402
from gance_tpu.viz import examples as jax_examples  # noqa: E402
from gance_tpu.viz import one_shot as jax_one_shot  # noqa: E402
from gance_tpu_torch import types as port_types  # noqa: E402
from gance_tpu_torch.audio.io import fabricate_percussive_wav  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.synthesis.runtime import SynthesisNetwork  # noqa: E402
from gance_tpu_torch.viz import examples, one_shot  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

# gance_tpu's demo network config (viz/examples.py), 32px
DEMO = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=64, dlatent_size=64,
            mapping_layers=2, mapping_fmaps=64)


@pytest.fixture(scope="module")
def networks():
    """(the port's, gance_tpu's) demo network of gance_tpu's key-0 params."""
    params = jax_g.init_generator_params(jax.random.PRNGKey(0), jax_g.GeneratorConfig(**DEMO))
    port = SynthesisNetwork(
        params=params_from_reference(jax.tree_util.tree_map(np.asarray, params)),
        config=port_g.GeneratorConfig(**DEMO), device="cpu")
    return port, JaxSynthesisNetwork(params=params, config=jax_g.GeneratorConfig(**DEMO))


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    return fabricate_percussive_wav(tmp_path_factory.mktemp("wav") / "song.wav", seconds=2.0)


@pytest.fixture()
def raw_spill(monkeypatch):
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")


def png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def assert_halves(got: np.ndarray, want: np.ndarray) -> None:
    """[scatter | synthesis] frames: the scatter equal, the synthesis within
    1 step on 99.9%."""
    assert got.shape == want.shape
    half = got.shape[-2] // 2
    np.testing.assert_array_equal(got[..., :half, :], want[..., :half, :])
    steps = np.abs(got[..., half:, :].astype(int) - want[..., half:, :].astype(int))
    assert int(steps.max()) <= 1 and float(np.mean(steps == 0)) >= 0.999
    assert float(got[..., half:, :].std()) > 1.0  # the network drew something


def test_single_vector_single_network_visualization_matches_jax(networks, tmp_path):
    port, reference = networks
    vector = np.random.RandomState(1).randn(64).astype(np.float32)
    kwargs = dict(vector=vector, title="one", image_height=64, y_range=(-3.0, 3.0))
    one_shot.single_vector_single_network_visualization(
        output_image_path=tmp_path / "port.png", network=port, **kwargs)
    jax_one_shot.single_vector_single_network_visualization(
        output_image_path=tmp_path / "jax.png", network=reference, **kwargs)
    got = png(tmp_path / "port.png")
    assert got.shape == (64, 128, 3)
    assert_halves(got, png(tmp_path / "jax.png"))


def test_vectors_single_network_visualization_matches_jax(networks, tmp_path, raw_spill):
    """10 vectors: a batch of 8 and one of 2, as gance_tpu batches them."""
    port, reference = networks
    data = np.random.RandomState(2).randn(10 * 64).astype(np.float32)
    for module, net, name, types in ((one_shot, port, "port", port_types),
                                     (jax_one_shot, reference, "jax", jax_types)):
        module.vectors_single_network_visualization(
            types.VectorsLabel(data=data, vector_length=64, label="ten"),
            tmp_path / f"{name}.avi", net, video_height=48, video_fps=10.0)
    got = read_avi(tmp_path / "port.avi")[0]
    assert got.shape == (10, 48, 96, 3)
    assert_halves(got, read_avi(tmp_path / "jax.avi")[0])


NETWORK_FREE_DEMOS = ["sigmas_demo", "vertical_sweep_demo", "waterfall_demo"]
WAV_DEMOS = ["smoothing_demo", "rotation_demo", "reducer_demo", "synthesis_frame_demo"]
# the port's DSP functions of the WAV demos, with gance_tpu's counterparts
# (same module path under gance_tpu) and what the port's returns
JAX_DSP = [("audio.spectrogram", "compute_spectrogram", "tensor"),
           ("audio.spectrogram", "reshape_spectrogram_to_vectors", "tensor"),
           ("audio.spectrogram", "compute_spectrogram_smooth_scale", "tensor"),
           ("audio.vectors", "smooth_across_vectors", "numpy"),
           ("audio.dsp", "rotate_vectors_over_time", "tensor"),
           ("audio.reduction", "reduce_vector_gzip_compression_rolling_average", "types"),
           ("synthesis.inputs", "alpha_blend_vectors_max_rms_power_audio", "types")]
# the port's own DSP against gance_tpu's: the share of PNG values that
# differ, measured on the CPU (the port's float64 spectrogram has no float32
# floor, which moves the low bins, the axes' limits and the scatter points)
OWN_DSP_DIFFERING = {"smoothing_demo": 0.20, "rotation_demo": 0.08, "reducer_demo": 0.0002,
                     "synthesis_frame_demo": 0.05}


def feed_jax_dsp(monkeypatch) -> None:
    """The port's DSP functions answer with gance_tpu's."""
    import importlib

    from tests.test_torch_viz_pipelines import to_port

    for module, name, kind in JAX_DSP:
        reference = getattr(importlib.import_module(f"gance_tpu.{module}"), name)

        def run(*args, _reference=reference, _kind=kind, device=None, **kwargs):
            del device
            host = lambda v: v.numpy() if torch.is_tensor(v) else v  # noqa: E731
            out = _reference(*map(host, args), **{k: host(v) for k, v in kwargs.items()})
            if _kind == "tensor":
                return torch.from_numpy(np.array(out))
            return np.asarray(out) if _kind == "numpy" else to_port(out)

        monkeypatch.setattr(importlib.import_module(f"gance_tpu_torch.{module}"), name, run)


@pytest.fixture(scope="module")
def jax_demos(tmp_path_factory, wav):
    """gance_tpu's output of each demo: (its PNG, its video's frames or None)."""
    outputs = {}

    def output(demo: str):
        if demo not in outputs:
            directory = tmp_path_factory.mktemp(demo)
            args = (wav,) if demo in WAV_DEMOS else ()
            with pytest.MonkeyPatch.context() as monkeypatch:
                monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
                path = getattr(jax_examples, demo)(directory, *args)
            video = directory / f"{demo}.mp4"
            outputs[demo] = (path.name, png(path),
                             read_avi(video)[0] if video.exists() else None)
        return outputs[demo]

    return output


def run_port_demo(demo: str, directory, wav):
    directory.mkdir()
    args = (wav,) if demo in WAV_DEMOS else ()
    device = {} if demo in ("sigmas_demo", "waterfall_demo") else {"device": "cpu"}
    path = getattr(examples, demo)(directory, *args, **device)
    assert path.parent == directory
    video = directory / f"{demo}.mp4"
    return path.name, png(path), read_avi(video)[0] if video.exists() else None


@pytest.mark.parametrize("demo", NETWORK_FREE_DEMOS + WAV_DEMOS)
def test_demos_without_a_network_match_jax(demo, tmp_path, wav, raw_spill, jax_demos,
                                           monkeypatch):
    """Each demo's PNG (and rotation_demo's video) pixel for pixel; the WAV
    demos with the port's DSP answering with gance_tpu's."""
    if demo in WAV_DEMOS:
        feed_jax_dsp(monkeypatch)
    got = run_port_demo(demo, tmp_path / "port", wav)
    want = jax_demos(demo)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2] is None) == (want[2] is None) == (demo != "rotation_demo")
    if got[2] is not None:
        assert got[2].shape[1:] == (300, 300, 3)
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("demo", WAV_DEMOS)
def test_wav_demos_with_the_ports_own_dsp(demo, tmp_path, wav, raw_spill, jax_demos):
    """With the port's own DSP: the same files and shapes, and at most the
    measured share of values differing."""
    got = run_port_demo(demo, tmp_path / "port", wav)
    want = jax_demos(demo)
    assert got[0] == want[0] and got[1].shape == want[1].shape
    differing = float(np.mean(got[1] != want[1]))
    assert differing <= OWN_DSP_DIFFERING[demo]


def test_quick_look_demo_matches_jax_through_its_network(networks, tmp_path, raw_spill,
                                                         monkeypatch):
    port, reference = networks
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = examples.quick_look_demo(tmp_path / "port", network=port)
    want = jax_examples.quick_look_demo(tmp_path / "jax")  # its own key-0 network
    assert got.name == want.name == "quick_look.png"
    assert png(got).shape == (128, 256, 3)
    assert_halves(png(got), png(want))
    frames = read_avi(tmp_path / "port" / "quick_look.mp4")[0]
    assert frames.shape == (6, 128, 256, 3)
    assert_halves(frames, read_avi(tmp_path / "jax" / "quick_look.mp4")[0])


def test_blog_media_demo_matches_jax_through_its_network(networks, tmp_path):
    pytest.importorskip("h5py")
    port, _ = networks
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = examples.blog_media_demo(tmp_path / "port", network=port)
    jax_examples.blog_media_demo(tmp_path / "jax")  # its own key-0 network
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert len(names) == 7 and got.name == "projection_final_original.png"
    assert sorted(p.name for p in (tmp_path / "port").glob("*.png")) == names
    for name in names:
        image = png(tmp_path / "port" / name)
        assert image.shape == (128, 256, 3)
        assert_halves(image, png(tmp_path / "jax" / name))


def test_demo_networks_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        examples.quick_look_demo(tmp_path)


def test_the_ports_own_demo_network_renders(tmp_path, raw_spill):
    """Without a network the port draws its own (seeded numpy, not JAX's
    threefry): the same files and shapes, and two runs agree."""
    for run in ("a", "b"):
        (tmp_path / run).mkdir()
        examples.quick_look_demo(tmp_path / run, device="cpu")
    a, b = png(tmp_path / "a" / "quick_look.png"), png(tmp_path / "b" / "quick_look.png")
    assert a.shape == (128, 256, 3) and float(a[:, 128:].std()) > 1.0
    np.testing.assert_array_equal(a, b)
    assert read_avi(tmp_path / "a" / "quick_look.mp4")[0].shape == (6, 128, 256, 3)
