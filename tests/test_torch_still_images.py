"""
The port's still-image surface against gance_tpu's, on the CPU, with two
16px networks written by JAX's `save_generator_pickle`:

- synthesis files written by each package and read by the other, and the
  v0/v1 migrations on fabricated JSON;
- `images-from-network`: the same file names and z as JAX's CLI from the
  same pickles and seed, images within 1 uint8 step; with a fake face
  finder (a face on every third image, in call order) the same accepted
  vectors in both labels;
- `synthesis-file-into-networks`: JAX's replay of the same sidecars, within
  1 uint8 step;
- `check_move_networks`: the same copied files under the same names as
  JAX's CLI from a directory with a duplicate, a truncated pickle, a pickle
  with a mis-shaped parameter and a `submit_config.pkl`; and a kernel
  wrapper that raises is not turned into a rejected network.
"""

import json
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("cv2")

import numpy as np  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from gance_tpu.cli.check_move_networks import cli as jax_check_cli  # noqa: E402
from gance_tpu.cli.synthesize_images import cli as jax_images_cli  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.overlay import faces as jax_faces  # noqa: E402
from gance_tpu.pipelines import synthesis_file as jax_synthesis_file  # noqa: E402
from gance_tpu_torch.cli.check_move_networks import cli as check_cli  # noqa: E402
from gance_tpu_torch.cli.synthesize_images import cli as images_cli  # noqa: E402
from gance_tpu_torch.media.images import read_image  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops  # noqa: E402
from gance_tpu_torch.overlay import faces as port_faces  # noqa: E402
from gance_tpu_torch.pipelines import check_move_networks, synthesis_file  # noqa: E402
from gance_tpu_torch.utils.hashing import hash_file  # noqa: E402
from tests.test_torch_pipelines import init_params  # noqa: E402


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("still") / "nets"
    d.mkdir()
    for i in range(2):
        save_generator_pickle(init_params(i), d / f"{i}_net.pkl")
    return d


def uint8_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    assert a.shape == b.shape
    return np.abs(a.astype(int) - b.astype(int))


@pytest.mark.parametrize("writer,reader", [(jax_synthesis_file, synthesis_file),
                                           (synthesis_file, jax_synthesis_file)])
def test_synthesis_files_cross_read(tmp_path, writer, reader):
    vector = np.random.RandomState(3).standard_normal(512).astype(np.float32)
    path = tmp_path / "s.json"
    writer.write_synthesis_file(path, vector, Path("n.pkl"), "a" * 32, Path("i.png"), "b" * 32)
    loaded = reader.read_synthesis_file(path)
    assert (loaded.network_path, loaded.network_hash, loaded.image_path, loaded.image_hash,
            loaded.version) == ("n.pkl", "a" * 32, "i.png", "b" * 32, 2)
    np.testing.assert_array_equal(reader.read_vector_in_file(path), vector)


@pytest.mark.parametrize("version", [None, 0, 1])
def test_synthesis_file_migrations_match_jax(tmp_path, version):
    vector = np.random.RandomState(4).standard_normal(512).tolist()
    blob = {"vector": [vector] if version in (None, 0) else vector, "model_path": "old.pkl",
            "model_hash": "c" * 32, "image_path": "x.png", "image_hash": "d" * 32}
    if version is not None:
        blob["version"] = version
    path = tmp_path / "old.json"
    path.write_text(json.dumps(blob))
    got, want = synthesis_file.read_synthesis_file(path), jax_synthesis_file.read_synthesis_file(path)
    assert (got.network_path, got.network_hash, got.version) == (
        want.network_path, want.network_hash, want.version) == ("old.pkl", "c" * 32, version)
    np.testing.assert_array_equal(synthesis_file.read_vector_in_file(path),
                                  jax_synthesis_file.read_vector_in_file(path))
    assert synthesis_file.read_vector_in_file(path).shape == (512,)  # the v0 fix


def run_images(cli, nets: Path, out: Path, *options: str) -> None:
    result = CliRunner().invoke(cli, ["images-from-network", "--networks-directory", str(nets),
                                      "--output-directory", str(out), *options])
    assert result.exit_code == 0, result.output + repr(result.exception)


def read_pairs(out: Path) -> dict:
    pairs = {}
    for sidecar in sorted(out.glob("*.json")):
        loaded = synthesis_file.read_synthesis_file(sidecar)
        image = Path(loaded.image_path)
        assert image == out / f"{sidecar.stem}.png" and hash_file(image) == loaded.image_hash
        pairs[sidecar.name] = (np.asarray(loaded.vector), read_image(image))
    return pairs


def test_images_from_network_matches_jax(tmp_path, nets):
    run_images(images_cli, nets, tmp_path / "port", "--num-faces", "0", "--no-faces", "3",
               "--random-seed", "7", "--device", "cpu")
    run_images(jax_images_cli, nets, tmp_path / "jax", "--num-faces", "0", "--no-faces", "3",
               "--random-seed", "7")
    got, want = read_pairs(tmp_path / "port"), read_pairs(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert len(got) == 6 and all("_no_face_" in name for name in got)
    rng = np.random.RandomState(7)  # each network draws anew from the seed
    first = rng.standard_normal((8, 512)).astype(np.float32)[:3]
    for name, (vector, image) in got.items():
        np.testing.assert_array_equal(vector, want[name][0])
        np.testing.assert_array_equal(vector, first[int(name.split("_")[-1][0])])
        assert int(uint8_steps(image, want[name][1]).max()) <= 1


def test_rejection_sampling_accepts_the_same_vectors(tmp_path, nets, monkeypatch):
    for faces in (port_faces, jax_faces):
        calls = []

        def face_locations(self, image, _calls=calls):
            _calls.append(1)
            return [(0, 1, 1, 0)] if len(_calls) % 3 == 0 else []

        monkeypatch.setattr(faces.FaceFinderProxy, "face_locations", face_locations)
    options = ("--num-faces", "3", "--no-faces", "4", "--random-seed", "5")
    run_images(images_cli, nets, tmp_path / "port", *options, "--device", "cpu")
    run_images(jax_images_cli, nets, tmp_path / "jax", *options)
    got, want = read_pairs(tmp_path / "port"), read_pairs(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert sum("_face_" in n and "_no_face_" not in n for n in got) == 6
    for name, (vector, _) in got.items():
        np.testing.assert_array_equal(vector, want[name][0])


def test_synthesis_file_into_networks_matches_jax(tmp_path, nets):
    sidecars = tmp_path / "sidecars"
    run_images(images_cli, nets, sidecars, "--num-faces", "0", "--no-faces", "5", "--device",
               "cpu")
    args = ["synthesis-file-into-networks", "--synthesis-files-dir", str(sidecars),
            "--networks-dir", str(nets)]
    result = CliRunner().invoke(images_cli, args + ["--output-directory", str(tmp_path / "port"),
                                                   "--device", "cpu"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    result = CliRunner().invoke(jax_images_cli, args + ["--output-directory", str(tmp_path / "jax")])
    assert result.exit_code == 0, result.output
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 2 * 10
    for name in names:
        assert int(uint8_steps(read_image(tmp_path / "port" / name),
                               read_image(tmp_path / "jax" / name)).max()) <= 1
    for sidecar in sidecars.glob("*.json"):  # a vector's own network gives its own image
        network = sidecar.name.split("_")[0]
        replayed = read_image(tmp_path / "port" / f"{network}_net_{sidecar.stem}.png")
        assert int(uint8_steps(replayed, read_image(sidecar.with_suffix(".png"))).max()) <= 1
    missing = CliRunner().invoke(images_cli, ["synthesis-file-into-networks", "--networks-dir",
                                              str(nets), "--output-directory", str(tmp_path)])
    assert missing.exit_code != 0 and "No synthesis files" in missing.output


@pytest.fixture()
def candidates(tmp_path, nets):
    d = tmp_path / "candidates"
    d.mkdir()
    for name in ("0_net.pkl", "1_net.pkl"):
        shutil.copy2(nets / name, d / name)
    shutil.copy2(nets / "0_net.pkl", d / "2_duplicate.pkl")  # the same md5
    data = (nets / "1_net.pkl").read_bytes()
    (d / "3_truncated.pkl").write_bytes(data[: len(data) // 2])
    params = init_params(0)
    params["synthesis"]["16x16"]["ToRGB"]["weight"] = params["synthesis"]["16x16"]["ToRGB"][
        "weight"][..., :2]
    save_generator_pickle(params, d / "4_misshaped.pkl")
    (d / "submit_config.pkl").write_bytes(b"not a network")
    return d


def test_check_move_networks_matches_jax(tmp_path, candidates):
    copied = {}
    for name, cli, extra in (("port", check_cli, ["--device", "cpu"]), ("jax", jax_check_cli, [])):
        out = tmp_path / name
        result = CliRunner().invoke(cli, ["--network-directory", str(candidates),
                                          "--output-directory", str(out), *extra])
        assert result.exit_code == 0, result.output + repr(result.exception)
        copied[name] = sorted(p.name for p in out.iterdir())
    assert copied["port"] == copied["jax"] == ["0_candidates_0_net.pkl",
                                               "1_candidates_1_net.pkl"]
    assert check_move_networks.validate_network(candidates / "3_truncated.pkl", "cpu")
    assert "16x16/ToRGB/weight" in check_move_networks.validate_network(
        candidates / "4_misshaped.pkl", "cpu")
    again = check_move_networks.check_move_networks_api([candidates], tmp_path / "port", "cpu")
    assert again == []  # every good network's md5 is already there


def test_a_kernel_failure_is_not_a_rejected_network(tmp_path, candidates, monkeypatch):
    def failing(*args, **kwargs):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(fused_ops, "_fused_bias_noise_lrelu_run", failing)
    with pytest.raises(RuntimeError, match="launch failure"):
        check_move_networks.validate_network(candidates / "0_net.pkl", "cpu")
    with pytest.raises(RuntimeError, match="launch failure"):
        check_move_networks.check_move_networks_api([candidates], tmp_path / "out", "cpu")
    assert not list((tmp_path / "out").iterdir())
