"""
The port's render CLIs over several devices and processes:
`music_into_networks noise-blend` and `projection-file-blend` with
--data-parallel on a CPU mesh in one process (a 'model' axis of 2 too, with
the large weights sharded by a lowered threshold), and with --dist-* as two gloo
processes that each synthesize half of every batch, against the
single-process render of the same command. Frames within 1 uint8 step on
99.9% of the values (the port's bound across batch shapes); only process 0
writes. The placement flags stay exclusive (JAX's ValueError). Every render
goes through the lossless raw AVI (GANCE_TPU_EGRESS=raw-spill).
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from click.testing import CliRunner  # noqa: E402

from gance_tpu_torch.cli.music_into_networks import cli  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.test_torch_pipelines import (  # noqa: E402,F401
    FLAGSHIP_FPS,
    FLAGSHIP_SIDE,
    assets,
    flagship_assets,
)
from tests.torch_parallel_worker import cpu_slots, free_port, launch  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

FRAMES = "8"


def noise_blend_args(assets, out):
    paths, wav = assets
    return ["noise-blend", "--wav", str(wav), "--output-path", str(out), "--networks-directory",
            str(paths[0].parent), "--output-fps", "10", "--output-side-length", "16",
            "--frames-to-visualize", FRAMES, "--device", "cpu"]


def flagship_args(a, out):
    return ["projection-file-blend", "--wav", str(a["percussive"]), "--output-path", str(out),
            "--networks-directory", str(a["paths"][0].parent), "--projection-file-path",
            str(a["projection"]), "--output-fps", str(FLAGSHIP_FPS), "--output-side-length",
            str(FLAGSHIP_SIDE), "--blend-depth", "3", "--frames-to-visualize", FRAMES,
            "--device", "cpu"]


def assert_most_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    steps = np.abs(got.astype(int) - want.astype(int))
    assert int(steps.max()) <= 1 and float(np.mean(steps == 0)) >= 0.999


def invoke(args, monkeypatch, devices=1):
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    cpu_slots(devices, monkeypatch)
    result = CliRunner().invoke(cli, args)
    assert result.exit_code == 0, result.output + repr(result.exception)


@pytest.fixture(params=["noise-blend", "projection-file-blend"])
def command(request, assets, flagship_assets):
    if request.param == "noise-blend":
        return lambda out: noise_blend_args(assets, out)
    return lambda out: flagship_args(flagship_assets, out)


def test_data_parallel_render_matches_single_device(tmp_path, monkeypatch, command):
    invoke(command(tmp_path / "plain.avi"), monkeypatch)
    invoke(command(tmp_path / "dp.avi") + ["--data-parallel", "2"], monkeypatch, devices=2)
    want, _, _ = read_avi(tmp_path / "plain.avi")
    got, _, _ = read_avi(tmp_path / "dp.avi")
    assert got.shape[0] == int(FRAMES)
    assert_most_within_one_step(got, want)


def test_tensor_parallel_render_matches_single_device(tmp_path, monkeypatch, command):
    """--data-parallel 2 over four CPU slots leaves a 'model' axis of 2 (the
    3x3 convs split by a lowered threshold): the render equals the
    single-device one within the bound above."""
    from gance_tpu_torch.parallel import mesh as port_mesh

    invoke(command(tmp_path / "plain.avi"), monkeypatch)
    monkeypatch.setattr(port_mesh, "_MIN_SHARDED_PARAM", 1024)
    made = []
    create = port_mesh.create_mesh
    monkeypatch.setattr(port_mesh, "create_mesh",
                        lambda *a, **k: made.append(create(*a, **k)) or made[-1])
    invoke(command(tmp_path / "tp.avi") + ["--data-parallel", "2"], monkeypatch, devices=4)
    assert [m.shape for m in made] == [{"data": 2, "model": 2}]
    want, _, _ = read_avi(tmp_path / "plain.avi")
    got, _, _ = read_avi(tmp_path / "tp.avi")
    assert got.shape[0] == int(FRAMES)
    assert_most_within_one_step(got, want)


def test_two_process_render_matches_single_process(tmp_path, monkeypatch, command):
    """Two --dist-* processes on the CPU (one slot each): pure data
    parallelism by default, rank 0 writes its output path, rank 1 writes
    nothing to its own."""
    invoke(command(tmp_path / "plain.avi"), monkeypatch)
    port = free_port()
    dist = ["--dist-coordinator", f"localhost:{port}", "--dist-num-processes", "2"]
    results = launch([[sys.executable, "-m", "gance_tpu_torch.cli.music_into_networks",
                       *command(tmp_path / f"rank{rank}.avi"), *dist, "--dist-process-id",
                       str(rank)] for rank in range(2)], timeout=300)
    for rank, (code, output) in enumerate(results):
        assert code == 0, f"rank {rank}: {output[-3000:]}"
    assert "defaulting to pure data parallelism over all 2 devices" in results[0][1]
    assert "coordinator-only write" in results[1][1]
    assert not (tmp_path / "rank1.avi").exists()
    want, _, _ = read_avi(tmp_path / "plain.avi")
    got, _, _ = read_avi(tmp_path / "rank0.avi")
    assert_most_within_one_step(got, want)


def test_placement_flags_are_exclusive(tmp_path, assets):
    result = CliRunner().invoke(cli, noise_blend_args(assets, tmp_path / "x.avi") + [
        "--data-parallel", "2", "--one-network-per-device"])
    assert isinstance(result.exception, ValueError)
    assert "mutually exclusive" in str(result.exception)
    assert not (tmp_path / "x.avi").exists()
