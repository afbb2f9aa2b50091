"""
Both pipelines' debug videos (gance_tpu_torch/pipelines/noise_blend.py and
projection_file_blend.py with a debug path) against gance_tpu's, on the CPU:
two 32px networks written by gance_tpu's `save_generator_pickle`, 12 output
frames. gance_tpu's frames are recorded where they enter its writers
(`write_source_to_disk_forward` for the hero video, `..._consume` for the
debug video, patched in its pipeline modules); the port's are read back from
its lossless raw AVIs (ffmpeg and cv2 hidden from the egress probes).

Fed gance_tpu's own inputs (its `VisualizationInput`, and its music mask),
the port's panel tiles equal gance_tpu's pixel for pixel and the
synthesized tiles lie within 1 uint8 step on at least 99.9% of values. From
the port's own inputs on broadband audio, where the inputs agree within
1e-4, the panels equal gance_tpu's too: measured, no scatter point moves
by a pixel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
pytest.importorskip("cv2")
pytest.importorskip("h5py")

import jax  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from gance_tpu.audio import reduction as jax_reduction  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.overlay import faces as jax_faces  # noqa: E402
from gance_tpu.pipelines import noise_blend as jax_nb  # noqa: E402
from gance_tpu.pipelines import projection_file_blend as jax_pfb  # noqa: E402
from gance_tpu_torch import types as port_types  # noqa: E402
from gance_tpu_torch.audio.io import read_wavs_scale_for_video  # noqa: E402
from gance_tpu_torch.audio.reduction import music_complexity_mask  # noqa: E402
from gance_tpu_torch.media import video  # noqa: E402
from gance_tpu_torch.overlay import faces as port_faces  # noqa: E402
from gance_tpu_torch.pipelines import noise_blend as port_nb  # noqa: E402
from gance_tpu_torch.pipelines import projection_file_blend as port_pfb  # noqa: E402
from gance_tpu_torch.projection import (  # noqa: E402
    LATEST_VERSION,
    ProjectionAttributes,
    ProjectionFileWriter,
)
from gance_tpu_torch.synthesis import inputs as port_inputs  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.torch_parallel_worker import cpu_slots  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

CONFIG = jax_g.GeneratorConfig(resolution=32, fmap_base=512, fmap_max=64, latent_size=512,
                               dlatent_size=512, mapping_layers=2, mapping_fmaps=512)
FPS = 10.0
FRAMES = 12
DEBUG_SIDE = 48
DEBUG_WINDOW = 5
BLEND = dict(alpha=0.25, fft_roll_enabled=False, fft_amplitude_range=(-1.0, 1.0))
PROJECTION_FPS = 5.0  # a frame multiplier of 2
FLAGSHIP_SIDE = 40
BLEND_DEPTH = 4
OVERLAY = dict(phash_distance=64, bbox_distance=3.0, track_length=3)
# per projection frame: the eye pair's x offset from the synthesized frame's
# (the bbox gate is 3 px), or None for no face; outputs repeat each twice
EYE_OFFSETS = [0, 1, 9, None, 0, 2]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz_pipelines")
    (d / "nets").mkdir()
    paths = []
    for seed in range(2):
        paths.append(d / "nets" / f"{seed}_net.pkl")
        save_generator_pickle(jax.tree_util.tree_map(
            np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(seed), CONFIG)), paths[-1])
    rate = 44100
    wav = d / "broadband.wav"
    noise = np.random.RandomState(23).uniform(-0.5, 0.5, int(rate * FRAMES / FPS))
    wavfile.write(str(wav), rate, (noise * 32767).astype(np.int16))
    return dict(d=d, paths=paths, wav=wav, projection=write_projection(d / "projection.hdf5"))


def targets(side: int = 32):
    rng = np.random.RandomState(22)
    return [np.repeat(np.repeat(rng.randint(0, 256, (4, 4, 3)).astype(np.uint8), side // 4, 0),
                      side // 4, 1) for _ in range(FRAMES // 2)]


def write_projection(path):
    """Seeded smooth 32px targets and rows-identical w+ of the networks' 8
    style rows, 5 fps, a final image per frame of its own."""
    rng = np.random.RandomState(21)
    count = FRAMES // 2
    attrs = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=True, original_target_path="targets.mp4",
        original_width_height=(32, 32), projection_width_height=(32, 32),
        target_md5_hash="0" * 32, original_network_path="0_net.pkl",
        network_md5_hash="0" * 32, steps_in_projection=1, noises_shapes=np.nan,
        latents_histories_enabled=False, noises_histories_enabled=False,
        images_histories_enabled=False, original_fps=PROJECTION_FPS,
        projection_fps=PROJECTION_FPS, original_frame_count=count,
        projection_frame_count=count)
    with ProjectionFileWriter(path, attrs) as writer:
        for target in targets():
            latents = np.broadcast_to(rng.randn(512).astype(np.float32),
                                      (1, CONFIG.num_style_rows, 512)).copy()
            with writer.frame_writer() as frame:
                frame.finish(target, latents, target[::-1].copy())
    return path


def hide_encoders(monkeypatch) -> None:
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    monkeypatch.setattr(video, "_cv2_available", lambda: False)
    monkeypatch.delenv("GANCE_TPU_EGRESS", raising=False)


def recorder(frames: list):
    def record(source, **_):
        for frame in source:
            frames.append(np.array(frame))
            yield frame

    return record


def record_jax(module, monkeypatch):
    """Patch a gance_tpu pipeline module's writers to record: (hero, debug)."""
    hero, debug = [], []
    monkeypatch.setattr(module, "write_source_to_disk_forward", recorder(hero))

    def consume(source, **_):
        for frame in source:
            debug.append(np.array(frame))

    monkeypatch.setattr(module, "write_source_to_disk_consume", consume)
    return hero, debug


def to_port(value):
    """A gance_tpu value (VisualizationInput, labels, ResultLayers, arrays)
    as the port's types, arrays on the host."""
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        name = type(value).__name__
        cls = (port_inputs.VisualizationInput if name == "VisualizationInput"
               else getattr(port_types, name))
        return cls(*[to_port(v) for v in value])
    if isinstance(value, list):
        return [to_port(v) for v in value]
    if hasattr(value, "shape"):
        return np.asarray(value)
    return value


def feed_jax_inputs(monkeypatch) -> None:
    """The port's pipelines fed gance_tpu's inputs and music mask."""
    def blend(module_function):
        def run(*args, device=None, **kwargs):
            del device
            return to_port(module_function(*args, **kwargs))
        return run

    monkeypatch.setattr(port_nb, "alpha_blend_vectors_max_rms_power_audio",
                        blend(jax_nb.alpha_blend_vectors_max_rms_power_audio))
    monkeypatch.setattr(port_pfb, "alpha_blend_projection_file",
                        blend(jax_pfb.alpha_blend_projection_file))
    monkeypatch.setattr(port_pfb.vector_reduction, "music_complexity_mask",
                        blend(jax_reduction.music_complexity_mask))


def tiles(frames: np.ndarray):
    """(N, S, k S, 3) debug frames -> k (N, S, S, 3) tiles."""
    return [frames[:, :, i * DEBUG_SIDE:(i + 1) * DEBUG_SIDE] for i in
            range(frames.shape[2] // DEBUG_SIDE)]


def within_one_step_share(got: np.ndarray, want: np.ndarray):
    steps = np.abs(got.astype(int) - want.astype(int))
    return int(steps.max()), float(np.mean(steps <= 1))


def assert_most_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    worst, share = within_one_step_share(got, want)
    assert worst <= 2 and share >= 0.999, (worst, share)


def noise_blend_args(a, debug_3d: bool):
    return dict(wav=[a["wav"]], network_paths=a["paths"], frames_to_visualize=FRAMES,
                output_fps=FPS, output_side_length=32, debug_window=DEBUG_WINDOW,
                debug_side_length=DEBUG_SIDE, debug_3d=debug_3d, **BLEND)


def port_noise_blend(a, out_dir, debug_3d: bool, monkeypatch, **kwargs):
    hide_encoders(monkeypatch)
    port_nb.noise_blend_api(output_path=out_dir / "hero.avi", debug_path=out_dir / "debug.avi",
                            device="cpu", **noise_blend_args(a, debug_3d), **kwargs)
    return read_avi(out_dir / "hero.avi")[0], read_avi(out_dir / "debug.avi")[0]


@pytest.fixture(scope="module")
def jax_noise_blend(assets, tmp_path_factory):
    """gance_tpu's noise-blend render with a debug path, (hero, debug)
    frames, by debug_3d; each rendered once."""
    renders = {}

    def render(debug_3d: bool):
        if debug_3d not in renders:
            with pytest.MonkeyPatch.context() as monkeypatch:
                hero, debug = record_jax(jax_nb, monkeypatch)
                jax_nb.noise_blend_api(output_path=tmp_path_factory.mktemp("jax") / "hero.avi",
                                       debug_path=assets["d"] / "never.avi",
                                       **noise_blend_args(assets, debug_3d))
            renders[debug_3d] = np.stack(hero), np.stack(debug)
        return renders[debug_3d]

    return render


@pytest.fixture(scope="module")
def port_noise_blend_2d(assets, tmp_path_factory):
    """The port's own render (its own inputs, default placement, no 3D):
    (hero, debug) frames."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        return port_noise_blend(assets, tmp_path_factory.mktemp("port"), False, monkeypatch)


@pytest.mark.parametrize("debug_3d", [False, True], ids=["2d", "3d"])
def test_noise_blend_debug_video_matches_jax_fed_its_inputs(assets, tmp_path, monkeypatch,
                                                            jax_noise_blend, debug_3d):
    jax_hero, jax_debug = jax_noise_blend(debug_3d)
    feed_jax_inputs(monkeypatch)
    hero, debug = port_noise_blend(assets, tmp_path, debug_3d, monkeypatch)
    assert hero.shape == jax_hero.shape == (FRAMES, 32, 32, 3)
    assert debug.shape == jax_debug.shape == (FRAMES, DEBUG_SIDE, 2 * DEBUG_SIDE, 3)
    assert_most_within_one_step(hero, jax_hero)
    (hero_tile, panel), (jax_hero_tile, jax_panel) = tiles(debug), tiles(jax_debug)
    assert_most_within_one_step(hero_tile, jax_hero_tile)
    np.testing.assert_array_equal(panel, jax_panel)
    assert all(not np.array_equal(p, q) for p, q in zip(panel, panel[1:]))  # the cursor moves


def test_noise_blend_debug_video_from_the_ports_inputs(port_noise_blend_2d, jax_noise_blend):
    """The port's own inputs on broadband audio: the hero tile within 1 step
    on 99.9%; the panels, measured, equal gance_tpu's pixel for pixel (the
    inputs' differences of at most 1e-4 move no scatter point by a pixel)."""
    _, debug = port_noise_blend_2d
    _, jax_debug = jax_noise_blend(False)
    (hero_tile, panel), (jax_hero_tile, jax_panel) = tiles(debug), tiles(jax_debug)
    assert_most_within_one_step(hero_tile, jax_hero_tile)
    np.testing.assert_array_equal(panel, jax_panel)


def test_noise_blend_debug_video_data_parallel_matches_default(assets, tmp_path, monkeypatch,
                                                               port_noise_blend_2d):
    """data_parallel=2 over two CPU slots: the debug video of the default
    placement, hero tiles within 1 step, panels equal."""
    _, want = port_noise_blend_2d
    cpu_slots(2, monkeypatch)
    _, got = port_noise_blend(assets, tmp_path, False, monkeypatch, data_parallel=2)
    assert got.shape == want.shape
    assert_most_within_one_step(tiles(got)[0], tiles(want)[0])
    np.testing.assert_array_equal(tiles(got)[1], tiles(want)[1])


def flagship_args(a, projection_path):
    audio = read_wavs_scale_for_video([a["wav"]], 512, target_num_vectors=FRAMES).wav_data
    mask = music_complexity_mask(audio, 512, 2, device="cpu").result.data
    return dict(wav=[a["wav"]], network_paths=a["paths"], frames_to_visualize=None,
                output_fps=FPS, output_side_length=FLAGSHIP_SIDE, debug_window=DEBUG_WINDOW,
                debug_side_length=DEBUG_SIDE, projection_file_path=projection_path,
                blend_depth=BLEND_DEPTH, complexity_change_rolling_sum_window=2,
                complexity_change_threshold=float(np.nanmedian(mask)), **OVERLAY, **BLEND)


def fake_landmarks(monkeypatch):
    """Both packages' landmark finders patched with one fake keyed on the
    scaled target frames."""
    import cv2

    keys = {cv2.resize(t, (FLAGSHIP_SIDE, FLAGSHIP_SIDE),
                       interpolation=cv2.INTER_CUBIC).tobytes(): i
            for i, t in enumerate(targets())}

    def eye_points(x: int, y: int):
        return [(x, y), (x + 2, y - 1), (x + 4, y), (x + 2, y + 1)]

    def face_landmarks(self, face_image):
        index = keys.get(np.ascontiguousarray(face_image).tobytes())
        if index is not None and EYE_OFFSETS[index] is None:
            return []
        x = 6 + (0 if index is None else EYE_OFFSETS[index])
        return [{"left_eye": eye_points(x, 8), "right_eye": eye_points(x + 8, 8)}]

    for faces in (jax_faces, port_faces):
        monkeypatch.setattr(faces.FaceFinderProxy, "face_landmarks", face_landmarks)


def test_flagship_debug_video_matches_jax_fed_its_inputs(assets, tmp_path, monkeypatch):
    """All six tiles: blended, foreground, the file's final image, the
    synthesis panel, the overlay panel and the music-mask panel."""
    fake_landmarks(monkeypatch)
    args = flagship_args(assets, assets["projection"])
    with pytest.MonkeyPatch.context() as patch:
        jax_hero, jax_debug = record_jax(jax_pfb, patch)
        jax_pfb.projection_file_blend_api(output_path=tmp_path / "jax.avi",
                                          debug_path=tmp_path / "never.avi", **args)
    jax_hero, jax_debug = np.stack(jax_hero), np.stack(jax_debug)
    feed_jax_inputs(monkeypatch)
    hide_encoders(monkeypatch)
    port_pfb.projection_file_blend_api(output_path=tmp_path / "hero.avi",
                                       debug_path=tmp_path / "debug.avi", device="cpu", **args)
    hero, debug = read_avi(tmp_path / "hero.avi")[0], read_avi(tmp_path / "debug.avi")[0]
    assert hero.shape == jax_hero.shape == (FRAMES, FLAGSHIP_SIDE, FLAGSHIP_SIDE, 3)
    assert debug.shape == jax_debug.shape == (FRAMES, DEBUG_SIDE, 6 * DEBUG_SIDE, 3)
    assert_most_within_one_step(hero, jax_hero)
    got, want = tiles(debug), tiles(jax_debug)
    assert_most_within_one_step(got[0], want[0])  # blended
    for i in (1, 2, 3, 4, 5):  # foreground, final image, the three panels
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"tile {i}")
    for panel in got[3:]:
        assert all(not np.array_equal(p, q) for p, q in zip(panel, panel[1:]))


def test_flagship_debug_video_without_the_overlay(assets, tmp_path, monkeypatch):
    """Without the overlay and the mask: [blended | final image | synthesis
    panel], from the port's own inputs; the blended tile is the hero frame
    resized, and the final-image tile is the file's, at the output's rate."""
    import cv2

    args = flagship_args(assets, assets["projection"])
    for key in ("complexity_change_rolling_sum_window", "complexity_change_threshold",
                *OVERLAY):
        args[key] = None
    hide_encoders(monkeypatch)
    port_pfb.projection_file_blend_api(output_path=tmp_path / "hero.avi",
                                       debug_path=tmp_path / "debug.avi", device="cpu",
                                       debug_3d=True, **args)
    hero, debug = read_avi(tmp_path / "hero.avi")[0], read_avi(tmp_path / "debug.avi")[0]
    assert debug.shape == (FRAMES, DEBUG_SIDE, 3 * DEBUG_SIDE, 3)
    blended, finals, _ = tiles(debug)
    resize = lambda f: cv2.resize(f, (DEBUG_SIDE, DEBUG_SIDE),  # noqa: E731
                                  interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(blended, np.stack([resize(f) for f in hero]))
    want = np.repeat(np.stack([resize(t[::-1].copy()) for t in targets()]), 2, axis=0)
    np.testing.assert_array_equal(finals, want)
