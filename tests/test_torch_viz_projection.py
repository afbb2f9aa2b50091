"""
The port's projection visualizations and re-synthesis readers
(gance_tpu_torch/projection/visualization.py, file_reader.py) against
gance_tpu's, on the CPU: one HDF5 projection file with latent histories,
written by the port's ProjectionFileWriter, and the 32px network of
tests/test_golden_image.py written by gance_tpu's `save_generator_pickle`.
The port re-synthesizes 8 latents per forward where JAX runs one: images
are held within 1 uint8 step on at least 99.9% of values. What is drawn
from the file alone (the triptych, the convergence plot) is held pixel for
pixel. Videos are written with GANCE_TPU_EGRESS=raw-spill and read back.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
pytest.importorskip("cv2")
pytest.importorskip("h5py")

import jax  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.projection import file_reader as jax_reader  # noqa: E402
from gance_tpu.projection import visualization as jax_viz  # noqa: E402
from gance_tpu.synthesis.runtime import SynthesisNetwork as JaxSynthesisNetwork  # noqa: E402
from gance_tpu_torch.projection import file_reader as port_reader  # noqa: E402
from gance_tpu_torch.projection import visualization as port_viz  # noqa: E402
from gance_tpu_torch.projection.file_writer import ProjectionFileWriter  # noqa: E402
from gance_tpu_torch.projection.projection_types import (  # noqa: E402
    LATEST_VERSION,
    ProjectionAttributes,
)
from gance_tpu_torch.synthesis.runtime import SynthesisNetwork  # noqa: E402
from gance_tpu_torch.utils.hashing import hash_file  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

CONFIG = jax_g.GeneratorConfig(resolution=32, fmap_base=512, fmap_max=64, latent_size=32,
                               dlatent_size=32, mapping_layers=2, mapping_fmaps=32)
FRAMES = 3
STEPS = 5


@pytest.fixture(scope="module")
def projection(tmp_path_factory):
    """(network pickle, projection file with latent histories): per frame a
    seeded final w, rows identical, and a history drifting into it."""
    d = tmp_path_factory.mktemp("viz_projection")
    pkl = d / "net.pkl"
    save_generator_pickle(jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(0), CONFIG)), pkl)
    rows = CONFIG.num_style_rows
    attrs = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=False, original_target_path="targets.mp4",
        original_width_height=(24, 24), projection_width_height=(24, 24),
        target_md5_hash="0" * 32, original_network_path=str(pkl),
        network_md5_hash=hash_file(pkl), steps_in_projection=STEPS, noises_shapes=np.nan,
        latents_histories_enabled=True, noises_histories_enabled=False,
        images_histories_enabled=False, original_fps=10.0, projection_fps=10.0,
        original_frame_count=FRAMES, projection_frame_count=FRAMES)
    rng = np.random.RandomState(31)
    path = d / "projection.hdf5"
    writer = ProjectionFileWriter(path, attrs)
    for _ in range(FRAMES):
        final = rng.randn(CONFIG.dlatent_size).astype(np.float32)
        drift = rng.randn(CONFIG.dlatent_size).astype(np.float32)
        with writer.frame_writer() as frame:
            for step in range(STEPS):
                w = final + drift * np.float32((STEPS - 1 - step) / STEPS)
                frame.record_step(step, np.tile(w, (1, rows, 1)), [], None)
            target = (rng.rand(24, 24, 3) * 255).astype(np.uint8)
            image = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            frame.finish(target, np.tile(final, (1, rows, 1)), image)
    writer.close(complete=True)
    return pkl, path


@pytest.fixture(scope="module")
def networks(projection):
    pkl, _ = projection
    return (SynthesisNetwork.from_pkl(pkl, device="cpu"), JaxSynthesisNetwork.from_pkl(pkl))


@pytest.fixture()
def raw_spill(monkeypatch):
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")


def assert_most_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    steps = np.abs(got.astype(int) - want.astype(int))
    assert int(steps.max()) <= 1 and float(np.mean(steps == 0)) >= 0.999


def test_network_outputs_at_final_latents_match_jax(projection, networks):
    _, path = projection
    port_net, jax_net = networks
    with port_reader.load_projection_file(path) as reader:
        got = np.stack(list(port_reader.network_outputs_at_final_latents(reader, port_net)))
    with jax_reader.load_projection_file(path) as reader:
        want = np.stack(list(jax_reader.network_outputs_at_final_latents(reader, jax_net)))
    assert got.shape == (FRAMES, 32, 32, 3)
    assert_most_within_one_step(got, want)


@pytest.mark.parametrize("step", [0, STEPS - 1])
def test_network_outputs_at_projection_step_match_jax(projection, networks, step):
    _, path = projection
    port_net, jax_net = networks
    with port_reader.load_projection_file(path) as reader:
        got = np.stack(list(port_reader.network_outputs_at_projection_step(
            reader, port_net, step)))
        label = port_reader.projection_history_step_matrices_label(reader, step)
    with jax_reader.load_projection_file(path) as reader:
        want = np.stack(list(jax_reader.network_outputs_at_projection_step(
            reader, jax_net, step)))
        want_label = jax_reader.projection_history_step_matrices_label(reader, step)
    assert_most_within_one_step(got, want)
    np.testing.assert_array_equal(label.data, want_label.data)
    assert (label.vector_length, label.label) == (want_label.vector_length, want_label.label)


def test_a_missing_history_step_raises_as_jax_does(projection, networks):
    _, path = projection
    messages = []
    for reader_module, net in ((port_reader, networks[0]), (jax_reader, networks[1])):
        with reader_module.load_projection_file(path) as reader:
            with pytest.raises(ValueError) as error:
                list(reader_module.network_outputs_at_projection_step(reader, net, STEPS))
        messages.append(str(error.value))
    assert messages[0] == messages[1] == f"History has no step {STEPS}"


def test_batched_resynthesis_matches_batch_one(projection, networks):
    """The port's batches of 8 against its own batch-1 forwards."""
    _, path = projection
    port_net = networks[0]
    with port_reader.load_projection_file(path) as reader:
        latents = [w for history in reader.latents_histories for w in history]
    got = np.stack(list(port_reader.images_in_batches(port_net, latents)))
    want = np.stack([port_net.images_from_matrices(w[None])[0] for w in latents])
    assert got.shape == (FRAMES * STEPS, 32, 32, 3)
    assert_most_within_one_step(got, want)


def test_projection_convergence_matches_jax(projection, tmp_path):
    _, path = projection
    got = port_viz.projection_convergence(path)
    want = jax_viz.projection_convergence(path)
    assert len(got) == FRAMES and all(len(c) == STEPS for c in got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert port_viz.percent_projected_steps(got, 0.5) == jax_viz.percent_projected_steps(want, 0.5)
    assert port_viz.percent_projected_steps(got) == jax_viz.percent_projected_steps(want)
    assert port_viz.projection_convergence(path, 2)[1].shape == (STEPS,)
    from PIL import Image

    port_viz.visualize_projection_convergence(path, tmp_path / "port.png")
    jax_viz.visualize_projection_convergence(path, tmp_path / "jax.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_visualize_final_latents_matches_jax(projection, tmp_path, raw_spill):
    _, path = projection
    port_viz.visualize_final_latents(path, tmp_path / "port.avi", video_height=48)
    jax_viz.visualize_final_latents(path, tmp_path / "jax.avi", video_height=48)
    got, want = read_avi(tmp_path / "port.avi")[0], read_avi(tmp_path / "jax.avi")[0]
    assert got.shape == (FRAMES, 48, 3 * 48, 3)
    np.testing.assert_array_equal(got, want)


def test_cli_visualize_final_latents_matches_jax(projection, tmp_path, raw_spill):
    from gance_tpu.cli.project_video_to_file import cli as jax_cli
    from gance_tpu_torch.cli.project_video_to_file import cli

    _, path = projection
    outs = []
    for name, command in (("port", cli), ("jax", jax_cli)):
        outs.append(tmp_path / f"{name}.avi")
        result = CliRunner().invoke(command, [
            "visualize-final-latents", "--projection-file", str(path), "--output-path",
            str(outs[-1]), "--video-height", "40"])
        assert result.exit_code == 0, result.output + repr(result.exception)
    got, want = read_avi(outs[0])[0], read_avi(outs[1])[0]
    assert got.shape == (FRAMES, 40, 120, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_visualize_projection_history_matches_jax(projection, tmp_path, raw_spill, stride):
    pkl, path = projection
    port_viz.visualize_projection_history(path, tmp_path / "port.avi", pkl, video_fps=10.0,
                                          steps_stride=stride, device="cpu")
    jax_viz.visualize_projection_history(path, tmp_path / "jax.avi", pkl, video_fps=10.0,
                                         steps_stride=stride)
    got, want = read_avi(tmp_path / "port.avi")[0], read_avi(tmp_path / "jax.avi")[0]
    assert got.shape == (FRAMES * len(range(0, STEPS, stride)), 32, 64, 3)
    np.testing.assert_array_equal(got[:, :, :32], want[:, :, :32])  # the targets
    assert_most_within_one_step(got, want)


def test_visualize_partial_projection_history_matches_jax(projection, tmp_path, raw_spill):
    pkl, path = projection
    port_viz.visualize_partial_projection_history(path, tmp_path / "port.avi", pkl, step=2,
                                                  device="cpu")
    jax_viz.visualize_partial_projection_history(path, tmp_path / "jax.avi", pkl, step=2)
    got, want = read_avi(tmp_path / "port.avi")[0], read_avi(tmp_path / "jax.avi")[0]
    assert got.shape == (FRAMES, 32, 64, 3)
    assert_most_within_one_step(got, want)


@pytest.mark.parametrize("function", ["visualize_projection_history",
                                      "visualize_partial_projection_history"])
def test_a_network_of_another_hash_raises_as_jax_does(projection, tmp_path, function):
    pkl, path = projection
    other = tmp_path / "other.pkl"
    other.write_bytes(pkl.read_bytes() + b"\0")
    extra = {} if function == "visualize_projection_history" else {"step": 1}
    messages = []
    for module, device in ((port_viz, {"device": "cpu"}), (jax_viz, {})):
        with pytest.raises(ValueError) as error:
            getattr(module, function)(path, tmp_path / "x.avi", other, **extra, **device)
        messages.append(str(error.value))
    assert messages[0] == messages[1] and "network_not_matching_ok" in messages[0]
    assert not (tmp_path / "x.avi").exists()


@pytest.mark.parametrize("function", ["visualize_projection_history",
                                      "visualize_partial_projection_history"])
def test_resynthesis_defaults_to_cuda_and_raises_without_it(projection, tmp_path, function):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    pkl, path = projection
    extra = {} if function == "visualize_projection_history" else {"step": 1}
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(port_viz, function)(path, tmp_path / "x.avi", pkl, **extra)
