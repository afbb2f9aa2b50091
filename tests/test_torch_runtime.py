"""
The port's synthesis runtime (gance_tpu_torch.synthesis.runtime) against
gance_tpu's, on the CPU: `SynthesisNetwork` and `MultiNetwork` render the same
frames from the same TF-format pickles (within 1 uint8 step: fp32 sums in
another order may flip a value on a step boundary), `synthesize_stream`
groups, pads and orders frames exactly as JAX does (alternating indices,
partial buckets), the multi-device modes render the same frames, a
tensor-parallel 'model' axis and a CUDA request without CUDA raise, and the port imports neither jax nor gance_tpu.
`models/frames.py::frames` gives each family's own apply bit for bit, and
the trainer loads without the runtime.
"""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.models.stylegan2 import GeneratorConfig, init_generator_params  # noqa: E402
from gance_tpu.synthesis import runtime as jax_rt  # noqa: E402
from gance_tpu_torch.models import frames as port_frames  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_sg2  # noqa: E402
from gance_tpu_torch.models import stylegan3 as port_sg3  # noqa: E402
from gance_tpu_torch.synthesis import runtime as port_rt  # noqa: E402
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402
from tests.torch_parallel_worker import cpu_slots  # noqa: E402

TINY = GeneratorConfig(resolution=16, fmap_base=256, fmap_max=32, latent_size=16,
                       dlatent_size=16, mapping_layers=2, mapping_fmaps=16)
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def two_networks(tmp_path_factory):
    d = tmp_path_factory.mktemp("nets")
    paths = []
    for i in range(2):
        params = jax.tree_util.tree_map(np.asarray, init_generator_params(jax.random.PRNGKey(i), TINY))
        params["dlatent_avg"] = np.random.RandomState(i).randn(16).astype(np.float32) * 0.3
        path = d / f"{i}_net.pkl"
        save_generator_pickle(params, path)
        paths.append(path)
    return paths


def assert_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_synthesis_network_matches_jax(two_networks):
    port = port_rt.SynthesisNetwork.from_pkl(two_networks[0], device="cpu")
    ref = jax_rt.SynthesisNetwork.from_pkl(two_networks[0])
    assert port.device == torch.device("cpu")
    assert port.expected_vector_length == ref.expected_vector_length == 16
    assert port.resolution == ref.resolution == 16
    assert all(t.device.type == "cpu" for t in jax.tree_util.tree_leaves(port.params))
    rng = np.random.RandomState(0)
    z = rng.randn(3, 16).astype(np.float32)
    mats = rng.randn(2, TINY.num_style_rows, 16).astype(np.float32)
    assert_within_one_step(port.images_from_vectors(z), ref.images_from_vectors(z))
    assert_within_one_step(port.images_from_matrices(mats), ref.images_from_matrices(mats))
    assert_within_one_step(port.images_generic(z), ref.images_generic(z))
    assert_within_one_step(port.create_image_generic(z[0]), ref.create_image_generic(z[0]))
    assert_within_one_step(port.create_image_generic(mats[0]), ref.create_image_generic(mats[0]))
    assert_within_one_step(port.create_image_vector(z[1]), ref.create_image_vector(z[1]))
    assert_within_one_step(port.create_image_matrix(mats[1]), ref.create_image_matrix(mats[1]))
    device_images = port.device_images_from_vectors(z)
    assert torch.is_tensor(device_images) and device_images.dtype == torch.uint8
    with pytest.raises(ValueError, match="dispatch"):
        port.images_generic(np.zeros((1, 2, 3, 4), np.float32))


def test_matrices_path_skips_mapping_and_truncation(two_networks):
    """w+ input goes straight to synthesis: changing psi changes vectors only."""
    staged = port_rt.SynthesisNetwork.stage_pkl(two_networks[1])
    plain = port_rt.SynthesisNetwork.from_staged(staged, two_networks[1], device="cpu")
    no_psi = port_rt.SynthesisNetwork.from_staged(
        staged, two_networks[1], device="cpu", truncation_psi=None)
    rng = np.random.RandomState(1)
    z, mats = rng.randn(2, 16).astype(np.float32), rng.randn(2, 8, 16).astype(np.float32)
    np.testing.assert_array_equal(plain.images_from_matrices(mats), no_psi.images_from_matrices(mats))
    assert np.abs(plain.images_from_vectors(z).astype(int)
                  - no_psi.images_from_vectors(z).astype(int)).max() > 1


def test_default_device_is_cuda_and_raises_without_it(two_networks):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would be used")
    with pytest.raises(RuntimeError, match="cuda"):
        port_rt.SynthesisNetwork.from_pkl(two_networks[0])
    with pytest.raises(RuntimeError, match="cuda"):
        port_rt.MultiNetwork(two_networks, load=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_rt.resolve_device("cuda")


def _model_axis_mesh():
    """A ('data', 'model') mesh with a 'model' axis of 2 on the CPU."""
    from gance_tpu_torch.parallel.mesh import Mesh, MeshDevice, _object_grid

    return Mesh(_object_grid([MeshDevice(0, torch.device("cpu"))] * 2, (1, 2)),
                ("data", "model"))


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=_model_axis_mesh()), "multi-device"),
    (dict(output_side_length=8), "resize_images"),
])
def test_deferred_network_options_raise(two_networks, kwargs, item):
    """Options that were deferred serve frames now: resize_images, and a
    tensor-parallel 'model' axis (multi-device), whose frames equal one
    device's within 1 uint8 step (bit for bit on the CPU)."""
    net = port_rt.SynthesisNetwork.from_pkl(two_networks[0], device="cpu", **kwargs)
    z = np.random.RandomState(3).randn(3, 16).astype(np.float32)
    frames = net.images_from_vectors(z)
    if item == "resize_images":
        assert frames.shape == (3, 8, 8, 3) and frames.dtype == np.uint8
        return
    single = port_rt.SynthesisNetwork.from_pkl(two_networks[0], device="cpu")
    want = single.images_from_vectors(z)
    assert frames.shape == want.shape and frames.dtype == np.uint8
    assert int(np.abs(frames.astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("kwargs", [
    dict(mesh="data"), dict(device_per_network=True), dict(network_parallel=True),
])
def test_deferred_multi_network_modes_raise(two_networks, kwargs, monkeypatch):
    """The multi-device modes, once deferred, now render: each streams the
    same frames as the default placement (within 1 uint8 step: a shard's
    convolutions run at another batch size) over two CPU slots. Combining
    two raises JAX's ValueError."""
    from gance_tpu_torch.parallel.mesh import create_mesh

    cpu_slots(2, monkeypatch)
    if kwargs.get("mesh") == "data":
        kwargs = dict(mesh=create_mesh(device="cpu"))
    rng = np.random.RandomState(3)
    z = rng.randn(11, 16).astype(np.float32)
    indices = np.array([0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0])
    with port_rt.MultiNetwork(two_networks, device="cpu") as plain:
        want = plain.synthesize_all(z, indices, batch_size=4)
    with port_rt.MultiNetwork(two_networks, device="cpu", **kwargs) as multi:
        assert_within_one_step(multi.synthesize_all(z, indices, batch_size=4), want)
        assert_within_one_step(multi.indexed_create_image_vector(1, z[2]), want[2])
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_rt.MultiNetwork(two_networks, device="cpu", device_per_network=True, **(
            dict(network_parallel=True) if "device_per_network" in kwargs else kwargs))


def test_output_side_length_equal_to_resolution_is_accepted(two_networks):
    net = port_rt.SynthesisNetwork.from_pkl(two_networks[0], device="cpu", output_side_length=16)
    assert net.images_from_vectors(np.zeros((1, 16), np.float32)).shape == (1, 16, 16, 3)


def _family_case(case):
    """(family module, prepared params, config, output side) of a tiny CPU network."""
    if case == "sg3":
        config = port_sg3.StyleGAN3Config(resolution=32, num_layers=6, channel_base=1024,
                                          channel_max=32)
        params = params_to_device(port_sg3.init_generator_params(7, config), CPU)
        return port_sg3, port_frames.prepare(params, config), config, None
    config = port_sg2.GeneratorConfig(resolution=16, fmap_base=256, fmap_max=32, latent_size=16,
                                      dlatent_size=16, mapping_layers=2, mapping_fmaps=16)
    params = port_sg2.init_generator_params(7, config)
    params["dlatent_avg"] = np.random.RandomState(8).randn(16).astype(np.float32)
    for name, block in params["synthesis"].items():  # the constant noise moves the frames
        for layer in block.values() if name != "noise" else ():
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(0.5)
    side = 24 if case == "sg2-resized" else None
    return port_sg2, params_to_device(params, CPU), config, side


@pytest.mark.parametrize("case", ["sg2", "sg2-resized", "sg3"])
def test_frames_is_each_familys_own_apply(case):
    """`models/frames.py::frames`, the one road from a batch to frames, gives
    bit for bit what the family's own apply gives: z through the generator
    with truncation, w+ through synthesis alone, constant noise, uint8 fused
    at the resolution, else the float render resized and then quantised."""
    model, prepared, config, side = _family_case(case)
    rng = np.random.RandomState(9)
    z = torch.from_numpy(rng.randn(3, config.latent_size).astype(np.float32))
    ws = torch.from_numpy(rng.randn(3, config.num_style_rows, config.dlatent_size)
                          .astype(np.float32))
    fused = side is None
    want_z = model.generator_apply(prepared, z, config, truncation_psi=0.7, noise_mode="const",
                                   uint8_output=fused)
    want_ws = model.synthesis_apply(prepared, ws, config, noise_mode="const", uint8_output=fused)
    if not fused:
        want_z, want_ws = (port_sg2.images_to_uint8(port_sg2.resize_images(w, side))
                           for w in (want_z, want_ws))
    for batch, want in ((z, want_z), (ws, want_ws)):
        got = port_frames.frames(prepared, batch, config, truncation_psi=0.7,
                                 compute_dtype=torch.float32, output_side_length=side)
        assert got.dtype == torch.uint8 and got.shape == (3, side or config.resolution,
                                                          side or config.resolution, 3)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="Cannot dispatch"):
        port_frames.frames(prepared, z[0], config, truncation_psi=0.7,
                           compute_dtype=torch.float32)


def test_training_imports_no_runtime():
    """`params_to_device` lives below the runtime: the trainer and the
    parallel layer load without `synthesis/runtime.py`."""
    code = ("import sys, gance_tpu_torch.parallel.training\n"
            "assert 'gance_tpu_torch.synthesis.runtime' not in sys.modules\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr


@pytest.mark.parametrize("batch_size,lookahead", [(3, 1), (3, 2), (4, 2)])
def test_multi_network_stream_matches_jax(two_networks, batch_size, lookahead):
    rng = np.random.RandomState(3)
    frames = rng.randn(11, 16).astype(np.float32)
    indices = np.array([0, 1, 0, 1, 1, 1, 0, 1, 0, 0, 1])
    with port_rt.MultiNetwork(two_networks, device="cpu") as port:
        got = port.synthesize_all(frames, indices, batch_size=batch_size, lookahead=lookahead)
        assert len(port) == 2 and port.network_indices == [0, 1]
        assert port.expected_vector_length == 16 and port.resolution == 16
        single = port.indexed_create_image_vector(1, frames[1])
    with jax_rt.MultiNetwork(two_networks) as ref:
        want = ref.synthesize_all(frames, indices, batch_size=batch_size, lookahead=lookahead)
    assert_within_one_step(got, want)
    assert_within_one_step(single, want[1])


class _CountingFake:
    """Wraps a fake network of either package and records the batch sizes it gets."""

    def __init__(self, fake):
        self.fake = fake
        self.path = None
        self.batches = []
        self.expected_vector_length = fake.expected_vector_length
        self.resolution = fake.resolution

    def device_images_generic(self, batch):
        self.batches.append(np.asarray(batch).shape[0])
        return self.fake.device_images_generic(batch)

    def create_image_generic(self, data):
        return self.fake.create_image_generic(data)


@pytest.mark.parametrize("n,batch_size,lookahead,period", [
    (16, 8, 1, 2), (16, 8, 2, 2), (24, 6, 1, 2), (24, 6, 2, 2), (13, 4, 2, 3), (5, 8, 2, 1),
])
def test_stream_grouping_and_padding_match_jax(n, batch_size, lookahead, period):
    """Alternating indices and partial buckets: the same dispatches, pads and order."""
    frames = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 16), np.float32) * 0.05
    indices = np.array([i % period for i in range(n)])
    results = []
    for rt in (port_rt, jax_rt):
        fakes = [_CountingFake(rt.FakeSynthesisNetwork(resolution=8, expected_vector_length=16))
                 for _ in range(period)]
        out = rt.MultiNetwork.from_networks(fakes).synthesize_all(
            frames, indices, batch_size=batch_size, lookahead=lookahead)
        expected = np.stack([fakes[indices[i]].create_image_generic(frames[i]) for i in range(n)])
        np.testing.assert_array_equal(out, expected)
        results.append((out, [f.batches for f in fakes]))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


def test_fake_network_matches_jax():
    port, ref = port_rt.FakeSynthesisNetwork(resolution=8), jax_rt.FakeSynthesisNetwork(resolution=8)
    data = np.random.RandomState(2).randn(3, 18, 512).astype(np.float32)
    for name in ("images_from_vectors", "images_from_matrices", "images_generic",
                 "device_images_generic"):
        np.testing.assert_array_equal(getattr(port, name)(data), getattr(ref, name)(data))
    for name in ("create_image_vector", "create_image_matrix", "create_image_generic"):
        np.testing.assert_array_equal(getattr(port, name)(data[0]), getattr(ref, name)(data[0]))
    assert port.config.resolution == 8 and port.expected_vector_length == 512


@pytest.mark.parametrize("real,batch_size", [
    (1, 8), (3, 8), (5, 8), (8, 8), (6, 8), (3, 6), (5, 6), (2, 4),
])
def test_bucket_size_and_pad_batch_match_jax(real, batch_size):
    size = port_rt._bucket_size(real, batch_size)
    assert size == jax_rt._bucket_size(real, batch_size)
    data = np.arange(real * 2, dtype=np.float32).reshape(real, 2)
    got, want = port_rt._pad_batch(data, size), jax_rt._pad_batch(data, size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == real


def test_multi_network_load_state_and_errors(two_networks):
    multi = port_rt.MultiNetwork(two_networks, device="cpu")
    with pytest.raises(ValueError, match="not loaded"):
        multi.indexed_create_image_vector(0, np.zeros(16))
    with multi:
        img = multi.indexed_create_image_matrix(1, np.zeros((8, 16), np.float32))
        assert img.shape == (16, 16, 3)
        assert multi.network(0).path == two_networks[0]
        with pytest.raises(ValueError, match="out of range"):
            list(multi.synthesize_stream(np.zeros((2, 16), np.float32), np.array([0, 2])))
    with pytest.raises(ValueError, match="not loaded"):
        multi.expected_vector_length  # pylint: disable=pointless-statement


def test_env_defaults_match_jax():
    assert port_rt.DEFAULT_BATCH_SIZE == jax_rt.DEFAULT_BATCH_SIZE
    assert port_rt.DEFAULT_STREAM_LOOKAHEAD == jax_rt.DEFAULT_STREAM_LOOKAHEAD
    assert str(port_rt.DEFAULT_COMPUTE_DTYPE).split(".")[-1] == np.dtype(
        jax_rt.DEFAULT_COMPUTE_DTYPE).name


def test_port_imports_neither_jax_nor_gance_tpu():
    """Import every port module (and chip_smoke) in a fresh interpreter."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "gance_tpu_torch").rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'gance_tpu' or m.startswith('gance_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert len(modules) >= 15
    # the projector slice: perceptual metric, weight import, projector, writer loop, CLI
    assert {"gance_tpu_torch.projection.lpips", "gance_tpu_torch.projection.vgg_import",
            "gance_tpu_torch.projection.projector", "gance_tpu_torch.projection.file_writer",
            "gance_tpu_torch.cli.project_video_to_file"} <= set(modules)
    # the serving slice: batcher, client, daemon, audio routes and the serve CLI
    assert {"gance_tpu_torch.serving", "gance_tpu_torch.serving.batcher",
            "gance_tpu_torch.serving.client", "gance_tpu_torch.serving.daemon",
            "gance_tpu_torch.serving.audio", "gance_tpu_torch.cli.serve"} <= set(modules)


def test_card_path_imports_no_host_only_package():
    """cv2, click, PIL, h5py, more_itertools and matplotlib are host-only
    packages that a GPU machine may lack (the chip machine has neither h5py
    nor matplotlib): the modules on the GPU path (and chip_smoke) must import
    without them. matplotlib comes in only with a debug output, through
    gance_tpu_torch.viz."""
    modules = ["gance_tpu_torch.pipelines.noise_blend", "gance_tpu_torch.media.video",
               "gance_tpu_torch.media", "gance_tpu_torch.media.native", "gance_tpu_torch.audio",
               "gance_tpu_torch.synthesis.inputs", "gance_tpu_torch.synthesis.orchestration",
               "gance_tpu_torch.utils.profiling", "gance_tpu_torch.projection",
               "gance_tpu_torch.overlay", "gance_tpu_torch.pipelines.projection_file_blend",
               "gance_tpu_torch.media.disk_tee", "gance_tpu_torch.projection.projector",
               "gance_tpu_torch.projection.lpips", "gance_tpu_torch.projection.vgg_import",
               "gance_tpu_torch.projection.file_writer", "gance_tpu_torch.media.resume",
               "gance_tpu_torch.media.spill", "gance_tpu_torch.pipelines.synthesis_file",
               "gance_tpu_torch.pipelines.check_move_networks",
               "gance_tpu_torch.overlay.selection", "gance_tpu_torch.serving",
               "gance_tpu_torch.serving.batcher", "gance_tpu_torch.serving.client",
               "gance_tpu_torch.serving.daemon", "gance_tpu_torch.serving.audio",
               "gance_tpu_torch.metrics", "gance_tpu_torch.metrics.frechet",
               "gance_tpu_torch.metrics.ppl", "gance_tpu_torch.metrics.training_eval",
               "gance_tpu_torch.projection.visualization", "gance_tpu_torch.models.stylegan3",
               "gance_tpu_torch.ops.filtered_lrelu", "chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'click', 'PIL', 'h5py', 'more_itertools', 'matplotlib', 'mpl_toolkits', "
        "'jax', 'jaxlib', 'gance_tpu'))\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
