"""
The port's data-parallel projector (`Projector(mesh=)`, `project_video_to_file
(mesh=)`) against gance_tpu's `TPUProjector(mesh=)` on the conftest's
virtual CPU devices.

  * two gloo processes, a pinned start (the w and planes handed in, jitter
    0) of 5 steps at batch 4, two frames a process, against JAX's projector
    over `create_mesh(n_devices=2)`: the per-step latents and the final
    latents and planes within 1e-3 (norm-wise relative), the distances
    within 1e-4 relative, the final images within 1 uint8 step (the bounds
    of tests/test_torch_projector.py). Over 4 devices (one frame a device)
    JAX's own trajectory leaves its single-device one by 1.9e-3 at step 4
    on these inputs (a frame's near-zero gradients, which Adam scales up),
    so the comparison is at 2 frames a device, where JAX's mesh and single
    device agree within 1.4e-5. That frame, frame 2, meets the near-zero
    gradients at step 3: JAX's 1- and 2-device runs leave each other by
    3.7e-5 at its step 4 (at most 4e-7 for the other frames), and the
    `Conv0_up` phases' rounding takes the port's step 4 5.1e-3 from JAX's
    (5 uint8 steps in its image). So frame 2's last step, final latents and
    image are held to the port alone (ROADMAP, departures): every output of
    the two processes equals bit for bit the port's projection of each
    process's two frames in one process;
  * a cold start (drawn planes, annealed jitter) over a 2-slot mesh equals
    the single-device projection: every slot keeps its rows of the whole
    batch's draws;
  * `project_video_to_file(mesh=)` raises the batch to fill the data axis;
  * when the coordinator's writer fails in a two-process projection, both
    processes exit (the coordinator at once, its peer in its next
    collective) instead of hanging.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.parallel import mesh as jax_mesh  # noqa: E402
from gance_tpu.projection import projector as jax_proj  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from gance_tpu_torch.projection import projector as port_proj  # noqa: E402
from tests.test_torch_projector import TINY, jax_params, norm_close, pinned_inputs  # noqa: E402
from tests.torch_parallel_worker import run_workers  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

STEPS, BATCH = 5, 4
SETTINGS = dict(num_steps=STEPS, dlatent_avg_samples=64)
# the frame of test_two_process_projection_matches_jax_mesh's inputs whose
# near-zero gradients at step 3 make its last step follow rounding
SENSITIVE_FRAME = 2


def test_two_process_projection_matches_jax_mesh(tmp_path):
    params = jax_params(50, TINY)
    targets, w0, noises = pinned_inputs(params, TINY, BATCH, seed=51)
    start = dict(initial_latents=w0, initial_noises=noises, noise_factor=0.0)
    projector = jax_proj.TPUProjector(params, jax_g.GeneratorConfig(**TINY),
                                      settings=jax_proj.ProjectorSettings(**SETTINGS),
                                      mesh=jax_mesh.create_mesh(n_devices=2))
    jax_steps = []
    want = projector.project_batch(targets, want_step_images=False, per_step_noises=False,
                                   step_callback=lambda s, lat, *_: jax_steps.append(lat[:, 0]),
                                   **start)
    outs = run_workers("project", dict(params=params_from_reference(params), config=TINY,
                                       settings=SETTINGS, targets=targets, start=start),
                       tmp_path, world=2, cpu_devices=1)
    alone = port_proj.Projector(params_from_reference(params), port_g.GeneratorConfig(**TINY),
                                settings=port_proj.ProjectorSettings(**SETTINGS), device="cpu")
    steps, results = [], []
    for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        part = []
        results += alone.project_batch(
            targets[rows], step_callback=lambda s, lat, *_: part.append(lat[:, 0].copy()),
            want_step_images=False, per_step_noises=False, initial_latents=w0[rows],
            initial_noises=[n[rows] for n in noises], noise_factor=0.0)
        steps.append(np.stack(part))
    steady = [i for i in range(BATCH) if i != SENSITIVE_FRAME]
    for out in outs:
        assert out["steps"].shape == (STEPS, BATCH, 16)
        for step in range(STEPS - 1):
            norm_close(out["steps"][step], jax_steps[step], 1e-3)
        norm_close(out["steps"][-1][steady], jax_steps[-1][steady], 1e-3)
        norm_close(out["latents"][steady], np.stack([want[i].final_latents for i in steady]), 1e-3)
        for i, plane in enumerate(out["noises"]):
            norm_close(plane, np.concatenate([r.noises[i] for r in want]), 1e-3)
        np.testing.assert_allclose(out["distances"], [r.final_distance for r in want],
                                   rtol=1e-4, atol=0)
        images = np.stack([want[i].final_image for i in steady])
        assert int(np.abs(out["images"][steady].astype(int) - images.astype(int)).max()) <= 1
        np.testing.assert_array_equal(out["steps"], np.concatenate(steps, axis=1))
        np.testing.assert_array_equal(out["latents"], np.stack([r.final_latents for r in results]))
        for i, plane in enumerate(out["noises"]):
            np.testing.assert_array_equal(plane, np.concatenate([r.noises[i] for r in results]))
        np.testing.assert_array_equal(out["distances"], [r.final_distance for r in results])
        np.testing.assert_array_equal(out["images"], np.stack([r.final_image for r in results]))
    np.testing.assert_array_equal(outs[0]["latents"], outs[1]["latents"])


def test_cold_start_over_a_mesh_equals_one_device():
    """The planes and every step's jitter are drawn for the whole batch on
    the first device, each slot keeping its rows: a 2-slot cold start equals
    the single device's within the pinned bounds."""
    params = params_from_reference(jax_params(52, TINY))
    targets = pinned_inputs(jax_params(52, TINY), TINY, BATCH, seed=53)[0]
    config = port_g.GeneratorConfig(**TINY)
    settings = port_proj.ProjectorSettings(**SETTINGS)
    single = port_proj.Projector(params, config, settings=settings, device="cpu")
    meshed = port_proj.Projector(params, config, settings=settings,
                                 mesh=create_mesh(devices=["cpu", "cpu"]))
    want = single.project_batch(targets, want_step_images=False, per_step_noises=False)
    got = meshed.project_batch(targets, want_step_images=False, per_step_noises=False)
    for a, b in zip(got, want):
        norm_close(a.final_latents, b.final_latents, 1e-4)
        norm_close(np.concatenate([n.ravel() for n in a.noises]),
                   np.concatenate([n.ravel() for n in b.noises]), 1e-4)
        assert abs(a.final_distance - b.final_distance) <= 1e-4 * b.final_distance


@pytest.fixture(scope="module")
def network_and_video(tmp_path_factory):
    from gance_tpu.media.video import write_source_to_disk_consume
    from gance_tpu.models.pickle_loader import save_generator_pickle

    d = tmp_path_factory.mktemp("projector_mesh")
    save_generator_pickle(jax_params(54, TINY), d / "net.pkl")
    rng = np.random.RandomState(55)
    write_source_to_disk_consume(
        iter([(rng.rand(16, 16, 3) * 255).astype(np.uint8) for _ in range(8)]),
        d / "source.mp4", video_fps=30.0)
    return d


def test_project_video_to_file_fills_the_data_axis(network_and_video, tmp_path, caplog):
    from gance_tpu_torch.projection import file_reader
    from gance_tpu_torch.projection.file_writer import project_video_to_file

    d = network_and_video
    with caplog.at_level("INFO", logger="gance_tpu_torch"):
        project_video_to_file(d / "source.mp4", d / "net.pkl", tmp_path / "p.hdf5",
                              steps_per_projection=2, num_frames_to_project=4,
                              mesh=create_mesh(devices=["cpu", "cpu"]), device="cpu")
    assert "Raising projection batch 1 -> 2" in caplog.text
    file_reader.verify_projection_file_assumptions(tmp_path / "p.hdf5")
    with file_reader.load_projection_file(tmp_path / "p.hdf5") as reader:
        assert len(list(reader.final_latents)) == 4


def test_projection_coordinator_writer_failure_aborts_peers(network_and_video, tmp_path):
    """JAX's tests/test_distributed.py::
    test_projection_coordinator_writer_failure_aborts_peers: the
    coordinator's writer raises on the first frame; both processes must
    exit non-zero well before the timeout, and no process reports success."""
    d = network_and_video
    results = run_workers("project_fail", dict(video=str(d / "source.mp4"),
                                               network=str(d / "net.pkl")),
                          tmp_path, world=2, cpu_devices=1, timeout=120, check=False)
    codes = [code for code, _ in results]
    assert None not in codes, "a process hung"
    assert all(code != 0 for code in codes), results
    assert "exiting so that peer processes abort" in results[0][1]
    assert "No space left on device (simulated)" in results[0][1]
    assert not (tmp_path / "out_0.pkl").exists() and not (tmp_path / "out_1.pkl").exists()
