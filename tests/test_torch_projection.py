"""
The port's projection-file layer (gance_tpu_torch.projection) and disk tee
(gance_tpu_torch.media.disk_tee) against gance_tpu's, on the CPU: files
written by one package's writer and read by the other's reader, bit for bit;
the version-1 attribute migration; the reference's swapped history layout;
the trailing-integer member order; the rows-identical verifier; the tee's
copies.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from gance_tpu.projection import file_reader as jax_reader  # noqa: E402
from gance_tpu.projection import file_writer as jax_writer  # noqa: E402
from gance_tpu.projection import projection_types as jax_types  # noqa: E402
from gance_tpu_torch.media import disk_tee  # noqa: E402
from gance_tpu_torch.projection import file_reader as port_reader  # noqa: E402
from gance_tpu_torch.projection import file_writer as port_writer  # noqa: E402
from gance_tpu_torch.projection import projection_types as port_types  # noqa: E402

ROWS = 6
SIDE = 8
STEPS = 2


def attributes(types, frames: int, histories: bool = False):
    return types.ProjectionAttributes(
        version_number=types.LATEST_VERSION, complete=False,
        original_target_path="targets/video.mp4", original_width_height=(SIDE, SIDE),
        projection_width_height=(SIDE, SIDE), target_md5_hash="ab" * 16,
        original_network_path="nets/0_net.pkl", network_md5_hash="cd" * 16,
        steps_in_projection=STEPS, noises_shapes=np.nan,
        latents_histories_enabled=histories, noises_histories_enabled=histories,
        images_histories_enabled=histories, original_fps=30.0, projection_fps=15.0,
        original_frame_count=2 * frames, projection_frame_count=frames,
    )


def seeded_frames(seed: int, frames: int):
    """(targets, rows-identical (1, ROWS, 512) latents, final images, per-step
    histories) of `frames` frames; each target's first pixel holds its index."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(frames):
        target = rng.randint(0, 256, (SIDE, SIDE, 3)).astype(np.uint8)
        target[0, 0, 0] = i
        latents = np.broadcast_to(rng.randn(512).astype(np.float32), (1, ROWS, 512)).copy()
        final = rng.randint(0, 256, (SIDE, SIDE, 3)).astype(np.uint8)
        steps = [(latents + s, [rng.randn(1, 1, 4, 4).astype(np.float32),
                                rng.randn(1, 1, 8, 8).astype(np.float32)],
                  rng.randint(0, 256, (SIDE, SIDE, 3)).astype(np.uint8)) for s in range(STEPS)]
        out.append((target, latents, final, steps))
    return out


def write(writer_module, types, path, frames, histories: bool = False) -> None:
    with writer_module.ProjectionFileWriter(path, attributes(types, len(frames), histories)) as w:
        for target, latents, final, steps in frames:
            with w.frame_writer() as frame:
                if histories:
                    for s, (lat, noises, image) in enumerate(steps):
                        frame.record_step(s, lat, noises, image)
                frame.finish(target, latents, final)


def read_all(reader_module, path):
    with reader_module.load_projection_file(path) as reader:
        attrs = reader.projection_attributes
        out = dict(
            attrs=attrs.__dict__,
            latents=list(reader.final_latents),
            targets=list(reader.target_images),
            finals=list(reader.final_images),
            matrices=reader_module.final_latents_matrices_label(reader),
        )
        if attrs.latents_histories_enabled:
            out.update(
                latents_histories=[list(h) for h in reader.latents_histories],
                images_histories=[list(h) for h in reader.images_histories],
                noises_histories=[list(h) for h in reader.noises_histories],
            )
        # each access is a fresh lazy iterator
        again = list(reader.target_images)
    assert len(again) == len(out["targets"])
    return out


def assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key in got:
        if key == "matrices":
            np.testing.assert_array_equal(got[key].data, want[key].data)
            assert got[key].vector_length == want[key].vector_length
            assert got[key].label == want[key].label
        elif key == "attrs":
            assert got[key].keys() == want[key].keys()
            for name, value in got[key].items():
                other = want[key][name]
                if isinstance(value, float) and np.isnan(value):
                    assert isinstance(other, float) and np.isnan(other), name
                else:
                    assert value == other, name
        else:  # lists of arrays, or of lists of arrays (histories)
            assert len(got[key]) == len(want[key]), key
            for x, y in zip(got[key], want[key]):
                pairs = list(zip(x, y)) if isinstance(x, list) else [(x, y)]
                assert not isinstance(x, list) or len(x) == len(y), key
                for u, v in pairs:
                    assert u.dtype == v.dtype, key
                    np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("histories", [False, True])
@pytest.mark.parametrize("direction", ["port-writes-jax-reads", "jax-writes-port-reads"])
def test_projection_file_round_trips_between_packages(tmp_path, direction, histories):
    frames = seeded_frames(1, 5)
    path = tmp_path / "projection.hdf5"
    if direction == "port-writes-jax-reads":
        write(port_writer, port_types, path, frames, histories)
    else:
        write(jax_writer, jax_types, path, frames, histories)
    port, jax = read_all(port_reader, path), read_all(jax_reader, path)
    assert_same(port, jax)
    assert port["attrs"]["complete"] and port["attrs"]["projection_frame_count"] == 5
    for got, (target, latents, final, steps) in zip(
            zip(port["targets"], port["latents"], port["finals"]), frames):
        np.testing.assert_array_equal(got[0], target)
        np.testing.assert_array_equal(got[1], latents[0])
        np.testing.assert_array_equal(got[2], final)
    if histories:
        np.testing.assert_array_equal(port["images_histories"][2][1], frames[2][3][1][2])
        np.testing.assert_array_equal(port["noises_histories"][0][0], np.concatenate(
            [n.ravel() for n in frames[0][3][0][1]]))
        assert port["attrs"]["noises_shapes"] == [(1, 1, 4, 4), (1, 1, 8, 8)]


def test_members_read_in_trailing_integer_order(tmp_path):
    """12 frames: lexicographic order would read frame 10 after frame 1."""
    frames = seeded_frames(2, 12)
    path = tmp_path / "projection.hdf5"
    write(port_writer, port_types, path, frames)
    with port_reader.load_projection_file(path) as reader:
        order = [int(t[0, 0, 0]) for t in reader.target_images]
        np.testing.assert_array_equal(reader.final_latents_at_frame(10), frames[10][1][0])
    assert order == list(range(12))
    with jax_reader.load_projection_file(path) as reader:
        assert [int(t[0, 0, 0]) for t in reader.target_images] == order


def test_version_1_attributes_migrate(tmp_path):
    path = tmp_path / "v1.hdf5"
    write(port_writer, port_types, path, seeded_frames(3, 2))
    with h5py.File(path, "a") as f:
        f.attrs["version_number"] = 1
        f.attrs["original_model_path"] = f.attrs.pop("original_network_path")
        f.attrs["model_md5_hash"] = f.attrs.pop("network_md5_hash")
    port, jax = read_all(port_reader, path), read_all(jax_reader, path)
    assert_same(port, jax)
    assert port["attrs"]["version_number"] == port_types.LATEST_VERSION
    assert port["attrs"]["original_network_path"] == "nets/0_net.pkl"
    assert port["attrs"]["network_md5_hash"] == "cd" * 16


def test_reference_swapped_histories_unswap_alike(tmp_path):
    """The reference's writer stores flattened noises under images_histories
    and images under noises_histories; both readers put them back."""
    frames = seeded_frames(4, 3)
    path = tmp_path / "swapped.hdf5"
    write(port_writer, port_types, path, frames, histories=True)
    with h5py.File(path, "a") as f:
        f.move("images_histories", "tmp_histories")
        f.move("noises_histories", "images_histories")
        f.move("tmp_histories", "noises_histories")
    port, jax = read_all(port_reader, path), read_all(jax_reader, path)
    assert_same(port, jax)
    with port_reader.load_projection_file(path) as reader:
        assert reader.histories_swapped
    for i, (_, _, _, steps) in enumerate(frames):
        for s, (_, noises, image) in enumerate(steps):
            np.testing.assert_array_equal(port["images_histories"][i][s], image)
            np.testing.assert_array_equal(port["noises_histories"][i][s],
                                          np.concatenate([n.ravel() for n in noises]))


def test_verify_rows_identical_raises_on_differing_rows(tmp_path):
    frames = seeded_frames(5, 3)
    good, bad = tmp_path / "good.hdf5", tmp_path / "bad.hdf5"
    write(port_writer, port_types, good, frames)
    port_reader.verify_projection_file_assumptions(good)
    frames[1][1][0, 3, 7] += 1.0
    write(port_writer, port_types, bad, frames)
    for module in (port_reader, jax_reader):
        with pytest.raises(ValueError, match="rows differ"):
            module.verify_projection_file_assumptions(bad)


def test_empty_projection_file_raises(tmp_path):
    path = tmp_path / "empty.hdf5"
    write(port_writer, port_types, path, [])
    with port_reader.load_projection_file(path) as reader:
        with pytest.raises(ValueError, match="was empty"):
            port_reader.final_latents_matrices_label(reader)


@pytest.mark.parametrize("serializer", ["NPY_SERIALIZER", "PICKLE_SERIALIZER",
                                        "HDF5_SERIALIZER"])
def test_disk_tee_copies_equal_the_source(serializer):
    rng = np.random.RandomState(6)
    source = [rng.randint(0, 256, (5, 7, 3)).astype(np.uint8) for _ in range(6)]
    primary, a, b = disk_tee.iterator_on_disk(iter(source), copies=2,
                                              serializer=getattr(disk_tee, serializer))
    first = list(primary)
    for stream in (first, list(a), list(b)):
        assert len(stream) == len(source)
        for got, want in zip(stream, source):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_disk_tee_secondary_ahead_of_primary_raises():
    primary, copy = disk_tee.iterator_on_disk(iter([np.zeros(3)]), copies=1)
    with pytest.raises(RuntimeError, match="ahead of the primary"):
        next(copy)
    assert len(list(primary)) == 1


def test_disk_tee_removes_its_directory_when_every_stream_is_done(tmp_path, monkeypatch):
    """Copies read by `zip`, which stops one short of their ends, and then
    closed: nothing is left in the temp directory. A tee nobody reads makes
    no directory."""
    monkeypatch.setattr(disk_tee.tempfile, "tempdir", str(tmp_path))
    source = [np.full(4, i) for i in range(5)]
    primary, copy = disk_tee.iterator_on_disk(iter(source), copies=1,
                                              serializer=disk_tee.NPY_SERIALIZER)
    assert len(list(zip(range(5), primary))) == 5
    assert len(list(tmp_path.iterdir())) == 1
    assert [int(x[0]) for _, x in zip(range(5), copy)] == list(range(5))
    primary.close()
    copy.close()
    assert list(tmp_path.iterdir()) == []
    disk_tee.iterator_on_disk(iter(source), copies=2)
    assert list(tmp_path.iterdir()) == []
