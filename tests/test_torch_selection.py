"""
The port's training-set preparation (gance_tpu_torch.overlay.selection and
cli/process_images.py) against gance_tpu's, on the CPU, on fabricated
capture directories: seeded noise JPEGs with Pi-style timestamped names,
bright ones standing for faces. Both packages' face finders are replaced by
one fake (a face when the image's mean is above 128), since no face image
is in the repository. The selections, their order and accounting, and every
file the three commands write must be equal.
"""

import json
import shutil
from datetime import datetime, timedelta
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("cv2")

import numpy as np  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from gance_tpu.cli.process_images import cli as jax_cli  # noqa: E402
from gance_tpu.overlay import faces as jax_faces  # noqa: E402
from gance_tpu.overlay import selection as jax_selection  # noqa: E402
from gance_tpu_torch.cli.process_images import cli  # noqa: E402
from gance_tpu_torch.media.images import read_image, write_image  # noqa: E402
from gance_tpu_torch.overlay import faces as port_faces  # noqa: E402
from gance_tpu_torch.overlay import selection  # noqa: E402

# per primary capture, in time order: a face or not
PRIMARY_FACES = [False, False, True, False, False, False, False, True, False, False]
SECONDARY_FACES = [True, False, False]


def fabricated(rng: np.random.RandomState, face: bool) -> np.ndarray:
    level = 200 if face else 40
    return np.clip(rng.normal(level, 20, (48, 64, 3)), 0, 255).astype(np.uint8)


@pytest.fixture()
def captures(tmp_path):
    rng = np.random.RandomState(41)
    primary, secondary = tmp_path / "primary", tmp_path / "secondary"
    start = datetime(2021, 10, 1, 9, 0, 0)
    # written out of time order, so that a name sort and a time sort differ
    for index in (3, 0, 7, 1, 9, 2, 8, 4, 6, 5):
        name = selection.create_image_filename(f"cam{9 - index}",
                                               start + timedelta(seconds=index))
        write_image(fabricated(np.random.RandomState(100 + index), PRIMARY_FACES[index]),
                    primary / name)
    for index, face in enumerate(SECONDARY_FACES):
        write_image(fabricated(rng, face), secondary / f"extra_{index}.jpeg")
    return primary, secondary


@pytest.fixture()
def fake_finder(monkeypatch):
    def face_locations(self, image):
        return [(0, 1, 1, 0)] if float(np.mean(image)) > 128 else []

    for faces in (port_faces, jax_faces):
        monkeypatch.setattr(faces.FaceFinderProxy, "face_locations", face_locations)


def test_timestamps_and_order_match_jax(captures):
    primary, secondary = captures
    ordered = selection.images_in_directory(primary)
    assert ordered == jax_selection.images_in_directory(primary)
    stamps = [selection.timestamp_from_filename(p) for p in ordered]
    assert stamps == sorted(stamps) and None not in stamps
    assert [p.name for p in ordered] != sorted(p.name for p in ordered)
    assert selection.images_in_directory(secondary) == sorted(secondary.iterdir())
    name = selection.create_image_filename("cam", datetime(2021, 1, 2, 3, 4, 5, 6000))
    assert name == jax_selection.create_image_filename("cam", datetime(2021, 1, 2, 3, 4, 5, 6000))
    assert selection.timestamp_from_filename(Path(name)) == datetime(2021, 1, 2, 3, 4, 5, 6000)
    assert selection.timestamp_from_filename(Path("no_stamp.jpeg")) is None


@pytest.mark.parametrize("num_images", [1, 2, 5, 9, None])
def test_selection_priority_matches_jax(captures, fake_finder, num_images):
    primary, secondary = captures
    kwargs = dict(primary_directories=[primary], secondary_directories=[secondary],
                  num_images=num_images)
    got = selection.select_images_for_training(**kwargs)
    want = jax_selection.select_images_for_training(**kwargs)
    assert tuple(got) == tuple(want)
    ordered = selection.images_in_directory(primary)
    faces = [p for p, face in zip(ordered, PRIMARY_FACES) if face]
    # primary faces, then the secondary face, then the primary faces' neighbours
    head = faces + [secondary / "extra_0.jpeg"]
    assert got.selected[: len(head)] == head[: len(got.selected)]
    if num_images == 9:
        assert (got.num_primary_faces, got.num_secondary_faces, got.num_neighbors,
                got.num_random) == (2, 1, 6, 0)
        # the window of the first face, then the second's, until the count is met
        assert got.selected[3:] == [ordered[i] for i in (0, 1, 3, 4, 5, 6)]
    if num_images is None:
        assert len(got.selected) == 13
        assert (got.num_neighbors, got.num_random) == (8, 2)


def test_scale_images_matches_jax(captures, tmp_path):
    primary, _ = captures
    for name, runner_cli in (("port", cli), ("jax", jax_cli)):
        result = CliRunner().invoke(runner_cli, [
            "scale-images", "--original-images-directory", str(primary), "--output-directory",
            str(tmp_path / name), "--scaled-image-width", "20", "--scaled-image-height", "12"])
        assert result.exit_code == 0, result.output + repr(result.exception)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 10 and all(n.startswith("20_12_cam") for n in names)
    for name in names:
        got = read_image(tmp_path / "port" / name)
        assert got.shape == (12, 20, 3)
        np.testing.assert_array_equal(got, read_image(tmp_path / "jax" / name))
    square = CliRunner().invoke(cli, ["scale-images", "--input-directory", str(primary),
                                      "--output-directory", str(tmp_path / "sq"),
                                      "--side-length", "8"])
    assert square.exit_code == 0 and read_image(next((tmp_path / "sq").iterdir())).shape == (
        8, 8, 3)


@pytest.mark.parametrize("no_delete", [False, True])
def test_scan_for_broken_images_matches_jax(captures, tmp_path, no_delete):
    primary, _ = captures
    left = {}
    for name, runner_cli in (("port", cli), ("jax", jax_cli)):
        directory = tmp_path / name
        shutil.copytree(primary, directory)
        (directory / "broken.jpeg").write_bytes(b"\xff\xd8\xff not a jpeg")
        (directory / "other.png").write_bytes(b"also broken, another extension")
        result = CliRunner().invoke(runner_cli, ["scan-for-broken-images", "--directory",
                                                 str(directory)]
                                    + (["--no-delete"] if no_delete else []))
        assert result.exit_code == 0, result.output + repr(result.exception)
        left[name] = sorted(p.name for p in directory.iterdir())
    assert left["port"] == left["jax"]
    assert ("broken.jpeg" in left["port"]) == no_delete and "other.png" in left["port"]


def test_select_images_copy_matches_jax(captures, tmp_path, fake_finder):
    primary, secondary = captures
    for spellings in (("--num-images", "4", "--output-directory"),
                      ("--target-num-images", "4", "--destination-directory")):
        out = {}
        for name, runner_cli in (("port", cli), ("jax", jax_cli)):
            target = tmp_path / f"{name}{spellings[0]}"
            result = CliRunner().invoke(runner_cli, [
                "select-images-copy", "--primary-directory", str(primary),
                "--secondary-directory", str(secondary), spellings[0], spellings[1],
                spellings[2], str(target)])
            assert result.exit_code == 0, result.output + repr(result.exception)
            out[name] = {p.name: p.read_bytes() for p in target.iterdir()}
        assert out["port"] == out["jax"]
        assert len(out["port"]) == 5  # four images and the summary
        summary = json.loads(out["port"]["selection_summary.json"])
        assert (summary["num_selected"], summary["num_primary_faces"],
                summary["num_secondary_faces"]) == (4, 2, 1)
    summary_path = tmp_path / "summary.json"
    result = CliRunner().invoke(cli, ["select-images-copy", "--primary-directory", str(primary),
                                      "--destination-directory", str(tmp_path / "all"),
                                      "--summary", str(summary_path)])
    assert result.exit_code == 0, result.output
    assert json.loads(summary_path.read_text())["num_selected"] == 10
    assert not (tmp_path / "all" / "selection_summary.json").exists()
