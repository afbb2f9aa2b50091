"""
The port's noise-blend pipeline (gance_tpu_torch.pipelines.noise_blend) and
its CLI against gance_tpu's, on the CPU: two 16px networks written by JAX's
`save_generator_pickle` and a 1 s percussive WAV at 10 fps. ffmpeg and cv2
are hidden from the egress probes (a host with neither), so the output is
the lossless raw+PCM AVI, read back with the RIFF reader of
tests/test_torch_media.py.

Frames are held to JAX's `vector_synthesis` fed the port's inputs within 1
uint8 step on at least 99.9% of pixels (fp32 sums in another order). Fed
JAX's own inputs, whose spectrogram carries JAX's float32 floor on this WAV
(tests/test_torch_audio.py), they are held within 2 steps, and within 1 on
at least 99.5%: tools/spectrogram_float32_floor.py reads max 2 steps, 99.78%
within 1, on the CPU. The network indices from the WAV equal JAX's. Also here: the bf16 tier
against JAX's bf16 frames at 32px (mean at most 1 step, max at most 12, the
bounds of a one-off check, now standing), the deferred options, and the CLI.

The flagship, projection-file blend: a projection file of 8 frames at 5 fps
(written by the port's writer) rendered at 10 fps and side 24 by the port and
by JAX's `projection_file_blend_api`, whose frames are recorded by patching
`write_source_to_disk_forward` in its module with a pass-through. On a
broadband WAV, where the inputs agree within 1e-4, frames within 1 uint8 step
on at least 99.9% of pixels; on the percussive WAV, max 2 and at least 99.5%
within 1 (the float64 spectrogram, as above). With the overlay on, both
packages' landmark finders are patched with one fake keyed on the scaled
target frames: the decisions are equal and composited regions are the
target's pixels.
"""

import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from click.testing import CliRunner  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from gance_tpu.audio.io import read_wavs_scale_for_video as jax_read_wavs  # noqa: E402
from gance_tpu.overlay import faces as jax_faces  # noqa: E402
from gance_tpu.pipelines import projection_file_blend as jax_pfb  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.synthesis.inputs import (  # noqa: E402
    alpha_blend_projection_file as jax_alpha_blend_projection_file,
)
from gance_tpu.synthesis.inputs import (  # noqa: E402
    alpha_blend_vectors_max_rms_power_audio as jax_alpha_blend,
)
from gance_tpu.synthesis.orchestration import vector_synthesis as jax_vector_synthesis  # noqa: E402
from gance_tpu.synthesis.runtime import MultiNetwork as JaxMultiNetwork  # noqa: E402
from gance_tpu_torch.audio.io import fabricate_percussive_wav, read_wavs_scale_for_video  # noqa: E402
from gance_tpu_torch.audio.reduction import music_complexity_mask, track_length_filter  # noqa: E402
from gance_tpu_torch.cli.music_into_networks import cli  # noqa: E402
from gance_tpu_torch.media import video  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.overlay import common as port_common  # noqa: E402
from gance_tpu_torch.overlay import faces as port_faces  # noqa: E402
from gance_tpu_torch.pipelines import projection_file_blend as port_pfb  # noqa: E402
from gance_tpu_torch.pipelines.noise_blend import noise_blend_api  # noqa: E402
from gance_tpu_torch.projection import (  # noqa: E402
    LATEST_VERSION,
    ProjectionAttributes,
    ProjectionFileWriter,
    final_latents_matrices_label,
    load_projection_file,
)
from gance_tpu_torch.synthesis.inputs import (  # noqa: E402
    alpha_blend_projection_file,
    alpha_blend_vectors_max_rms_power_audio,
)
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.torch_parallel_worker import cpu_slots  # noqa: E402

TINY = jax_g.GeneratorConfig(resolution=16, fmap_base=256, fmap_max=32, latent_size=512,
                             dlatent_size=512, mapping_layers=2, mapping_fmaps=512)
FPS = 10.0
BLEND = dict(alpha=0.25, fft_roll_enabled=False, fft_amplitude_range=(-1.0, 1.0))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    nets = d / "nets"
    nets.mkdir()
    for i in range(2):
        save_generator_pickle(init_params(i), nets / f"{i}_net.pkl")
    return sorted(nets.glob("*.pkl")), fabricate_percussive_wav(d / "song.wav", seconds=1.0)


def init_params(seed: int):
    return jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(seed), TINY))


def hide_encoders(monkeypatch) -> None:
    """A host with neither an ffmpeg binary nor cv2."""
    monkeypatch.setattr(video, "_ffmpeg_binary", lambda: None)
    monkeypatch.setattr(video, "_cv2_available", lambda: False)
    monkeypatch.delenv("GANCE_TPU_EGRESS", raising=False)


@pytest.fixture()
def no_encoders(monkeypatch):
    hide_encoders(monkeypatch)


def render(paths, wav, out: Path, **kwargs) -> None:
    args = dict(frames_to_visualize=None, output_fps=FPS, output_side_length=16,
                debug_path=None, debug_window=None, debug_side_length=None, **BLEND)
    args.update(kwargs)
    noise_blend_api([wav], out, paths, device="cpu", **args)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory, assets):
    """The port's render of the WAV, its inputs, and JAX's `vector_synthesis`
    frames of the same WAV fed the port's inputs and JAX's own."""
    paths, wav = assets
    out = tmp_path_factory.mktemp("render") / "video.avi"
    with pytest.MonkeyPatch.context() as monkeypatch:
        hide_encoders(monkeypatch)
        render(paths, wav, out)
    frames, audio, _ = read_avi(out)
    audio_512 = jax_read_wavs([wav], 512, frames_per_second=FPS).wav_data
    np.testing.assert_array_equal(
        read_wavs_scale_for_video([wav], 512, frames_per_second=FPS).wav_data, audio_512)
    port_inputs = alpha_blend_vectors_max_rms_power_audio(
        time_series_audio_vectors=audio_512, vector_length=512, network_indices=[0, 1],
        device="cpu", **BLEND)
    with JaxMultiNetwork(paths, output_side_length=16) as networks:
        jax_inputs = jax_alpha_blend(time_series_audio_vectors=audio_512, vector_length=512,
                                     network_indices=networks.network_indices, **BLEND)
        jax_of_port, jax_of_jax = (
            np.stack(list(jax_vector_synthesis(networks, fed).synthesized_images))
            for fed in (port_inputs, jax_inputs))
    return dict(frames=frames, audio=audio, port_inputs=port_inputs, jax_inputs=jax_inputs,
                jax_of_port=jax_of_port, jax_of_jax=jax_of_jax)


def uint8_steps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    assert got.shape == want.shape
    return np.abs(got.astype(int) - want.astype(int))


def test_noise_blend_matches_jax(assets, rendered):
    _, wav = assets
    np.testing.assert_array_equal(rendered["audio"], wavfile.read(str(wav))[1])
    indices = rendered["jax_inputs"].network_indices.result.data
    np.testing.assert_array_equal(rendered["port_inputs"].network_indices.result.data, indices)
    assert set(indices.tolist()) == {0, 1}  # the RMS switch really switches
    assert rendered["frames"].shape == (len(indices), 16, 16, 3)
    steps = uint8_steps(rendered["frames"], rendered["jax_of_port"])
    assert float(np.mean(steps <= 1)) >= 0.999, int(steps.max())


def test_noise_blend_matches_jax_fed_its_own_inputs(rendered):
    steps = uint8_steps(rendered["frames"], rendered["jax_of_jax"])
    assert int(steps.max()) <= 2
    assert float(np.mean(steps <= 1)) >= 0.995


def test_noise_blend_bf16_resized_with_a_trace(tmp_path, assets, no_encoders):
    paths, wav = assets
    out = tmp_path / "bf16.avi"
    render(paths, wav, out, frames_to_visualize=3, output_side_length=8,
           compute_dtype="bfloat16", trace_dir=tmp_path / "trace")
    frames, _, _ = read_avi(out)
    assert frames.shape == (3, 8, 8, 3) and float(frames.std()) > 0
    traces = list((tmp_path / "trace").glob("trace.*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_cli_noise_blend_writes_video_with_audio(tmp_path, assets, no_encoders):
    paths, wav = assets
    out = tmp_path / "cli.avi"
    result = CliRunner().invoke(cli, [
        "noise-blend", "--wav", str(wav), "--output-path", str(out),
        "--networks-directory", str(paths[0].parent), "--frames-to-visualize", "4",
        "--output-fps", str(FPS), "--output-side-length", "16", "--device", "cpu",
        "--run-config", str(tmp_path / "run.json"),
    ])
    assert result.exit_code == 0, result.output + repr(result.exception)
    frames, audio, _ = read_avi(out)
    assert frames.shape == (4, 16, 16, 3)
    np.testing.assert_array_equal(audio, wavfile.read(str(wav))[1])
    assert '"device": "cpu"' in (tmp_path / "run.json").read_text()


@pytest.mark.parametrize("option", [["--dist-coordinator", "localhost:1234"],
                                    ["--data-parallel", "2"], ["--one-network-per-device"],
                                    ["--debug-path", "debug.avi"]])
def test_cli_deferred_options_raise(tmp_path, assets, option, no_encoders):
    """Of the options once deferred, a partial --dist-* triple is JAX's usage
    error, and --data-parallel (one CPU slot: it degrades with JAX's
    warning), --one-network-per-device and --debug-path render; the debug
    video has the hero video's frames, each [hero | synthesis panel] at
    --debug-side-length."""
    paths, wav = assets
    out = tmp_path / "x.avi"
    if option[0] == "--debug-path":
        option = [option[0], str(tmp_path / option[1]), "--debug-side-length", "48"]
    result = CliRunner().invoke(cli, [
        "noise-blend", "--wav", str(wav), "--output-path", str(out),
        "--network-path", str(paths[0]), "--device", "cpu", "--frames-to-visualize", "4",
        "--output-side-length", "16", *option])
    if option[0] == "--debug-path":
        assert result.exit_code == 0, result.output + repr(result.exception)
        assert read_avi(out)[0].shape == (4, 16, 16, 3)
        debug, audio, _ = read_avi(option[1])
        assert debug.shape == (4, 48, 2 * 48, 3)
        np.testing.assert_array_equal(audio, wavfile.read(str(wav))[1])
    elif option[0] == "--dist-coordinator":
        assert result.exit_code == 2 and "must be given together" in result.output
    else:
        assert result.exit_code == 0, result.output
        assert read_avi(out)[0].shape == (4, 16, 16, 3)


def assert_most_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    """The port's frame bound across batch shapes: 1 uint8 step on 99.9%."""
    assert got.shape == want.shape
    steps = np.abs(got.astype(int) - want.astype(int))
    assert int(steps.max()) <= 1 and float(np.mean(steps == 0)) >= 0.999


@pytest.mark.parametrize("kwargs,item", [
    ({"data_parallel": 2}, "item 12"), ({"device_per_network": True}, "item 12"),
    ({"network_parallel": True}, "item 12"), ({"debug_path": Path("d.avi")}, "item 13"),
    ({"resumable": True, "debug_path": Path("d.avi")}, "debug visualization"),
])
def test_deferred_options_raise(tmp_path, assets, kwargs, item, rendered, monkeypatch):
    """The placements (item 12, part 1) render over two CPU slots the frames
    of the default placement; the debug video (item 13) renders the hero
    video's frames beside their synthesis panels, and a resumable render
    still refuses it."""
    paths, wav = assets
    if item == "item 13":
        hide_encoders(monkeypatch)
        render(paths, wav, tmp_path / "x.avi", debug_path=tmp_path / kwargs["debug_path"],
               debug_side_length=32)
        hero = read_avi(tmp_path / "x.avi")[0]
        assert_most_within_one_step(hero, rendered["frames"])
        debug = read_avi(tmp_path / "d.avi")[0]
        assert debug.shape == (len(hero), 32, 64, 3)
        assert any(not np.array_equal(a[:, 32:], b[:, 32:]) for a, b in zip(debug, debug[1:]))
        return
    if item != "item 12":
        with pytest.raises((NotImplementedError, ValueError), match=item):
            render(paths, wav, tmp_path / "x.avi", **kwargs)
        return
    cpu_slots(2, monkeypatch)
    hide_encoders(monkeypatch)
    render(paths, wav, tmp_path / "x.avi", frames_to_visualize=12, **kwargs)
    assert_most_within_one_step(read_avi(tmp_path / "x.avi")[0], rendered["frames"][:12])


def test_noise_blend_defaults_to_cuda_and_raises_without_it(tmp_path, assets):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    paths, wav = assets
    with pytest.raises(RuntimeError, match="cuda"):
        noise_blend_api([wav], tmp_path / "x.avi", paths, None, FPS, 16, None, None, None,
                        **BLEND)


@pytest.mark.parametrize("phase", [False, True])
def test_bf16_frames_match_jax_bf16(phase):
    """The port's bf16 tier against JAX's bf16 frames: 4 images at 32px, every
    noise strength 0.3, the standard and the phase path; mean at most 1 uint8
    step, max at most 12."""
    kw = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32, dlatent_size=32,
              mapping_layers=2, mapping_fmaps=32)
    config = jax_g.GeneratorConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax_g.init_generator_params(jax.random.PRNGKey(0), config))
    for block in params["synthesis"].values():
        for layer in block.values():
            if isinstance(layer, dict) and "noise_strength" in layer:
                layer["noise_strength"] = np.float32(0.3)
    z = np.random.RandomState(1234).randn(4, 32).astype(np.float32)
    want = np.asarray(jax_g.images_to_uint8(jax_g.generator_apply(
        params, jnp.asarray(z), config, truncation_psi=1.2, noise_mode="const",
        compute_dtype=jnp.bfloat16, phase_top_block_mode=phase)))
    with torch.inference_mode():
        got = port_g.images_to_uint8(port_g.generator_apply(
            params_to_device(params_from_reference(params), torch.device("cpu")),
            torch.from_numpy(z), port_g.GeneratorConfig(**kw), truncation_psi=1.2,
            noise_mode="const", compute_dtype=torch.bfloat16,
            phase_top_block_mode=phase)).numpy()
    steps = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape == (4, 32, 32, 3)
    assert float(steps.mean()) <= 1.0 and int(steps.max()) <= 12, (steps.mean(), steps.max())


# ------------------------------------------------------------ the flagship

PROJECTION_FPS = 5.0
PROJECTION_FRAMES = 8
FLAGSHIP_FPS = 10.0  # a frame multiplier of 2
FLAGSHIP_SIDE = 24  # the host's cubic scaling from the networks' 16px
BLEND_DEPTH = 4


def smooth_targets(seed: int, count: int, side: int = 16):
    rng = np.random.RandomState(seed)
    return [np.repeat(np.repeat(rng.randint(0, 256, (4, 4, 3)).astype(np.uint8), side // 4, 0),
                      side // 4, 1) for _ in range(count)]


def write_projection(path: Path, frames: int = PROJECTION_FRAMES, complete: bool = True) -> Path:
    """A projection file as the projector writes one: seeded smooth 16px
    targets and rows-identical w+ of the 16px networks' 6 style rows."""
    rng = np.random.RandomState(21)
    attrs = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=False, original_target_path="targets.mp4",
        original_width_height=(16, 16), projection_width_height=(16, 16),
        target_md5_hash="0" * 32, original_network_path="0_net.pkl",
        network_md5_hash="0" * 32, steps_in_projection=1, noises_shapes=np.nan,
        latents_histories_enabled=False, noises_histories_enabled=False,
        images_histories_enabled=False, original_fps=PROJECTION_FPS,
        projection_fps=PROJECTION_FPS, original_frame_count=frames,
        projection_frame_count=frames)
    writer = ProjectionFileWriter(path, attrs)
    for target in smooth_targets(22, frames):
        latents = np.broadcast_to(rng.randn(512).astype(np.float32), (1, 6, 512)).copy()
        with writer.frame_writer() as frame:
            frame.finish(target, latents, target)
    writer.close(complete=complete)
    return path


@pytest.fixture(scope="module")
def flagship_assets(tmp_path_factory, assets):
    pytest.importorskip("cv2")  # the flagship scales frames with cv2
    d = tmp_path_factory.mktemp("flagship")
    rate = 44100
    noise = np.random.RandomState(23).uniform(-0.5, 0.5, rate)
    broadband = d / "broadband.wav"
    wavfile.write(str(broadband), rate, (noise * 32767).astype(np.int16))
    return dict(paths=assets[0], percussive=assets[1], broadband=broadband,
                projection=write_projection(d / "projection.hdf5"))


def flagship_args(a: dict, wav: Path, **kwargs) -> dict:
    args = dict(wav=[wav], network_paths=a["paths"], frames_to_visualize=None,
                output_fps=FLAGSHIP_FPS, output_side_length=FLAGSHIP_SIDE, debug_path=None,
                debug_window=None, debug_side_length=None, projection_file_path=a["projection"],
                blend_depth=BLEND_DEPTH, **BLEND)
    args.update(kwargs)
    return args


def port_flagship(a: dict, wav: Path, out: Path, **kwargs):
    """The port's render through the lossless raw AVI: (frames, audio)."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        hide_encoders(monkeypatch)
        port_pfb.projection_file_blend_api(output_path=out, device="cpu",
                                           **flagship_args(a, wav, **kwargs))
    frames, audio, _ = read_avi(out)
    return frames, audio


def jax_flagship(a: dict, wav: Path, out: Path, **kwargs) -> np.ndarray:
    """JAX's render, its frames recorded where they enter the writer."""
    frames = []

    def record(source, **_):
        for frame in source:
            frames.append(np.array(frame))
            yield frame

    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(jax_pfb, "write_source_to_disk_forward", record)
        jax_pfb.projection_file_blend_api(output_path=out, **flagship_args(a, wav, **kwargs))
    return np.stack(frames)


def flagship_inputs(a: dict, wav: Path):
    """The port's and JAX's `alpha_blend_projection_file` inputs of `wav`."""
    audio = read_wavs_scale_for_video([wav], 512, target_num_vectors=16).wav_data
    np.testing.assert_array_equal(
        audio, jax_read_wavs([wav], 512, target_num_vectors=16).wav_data)
    with load_projection_file(a["projection"]) as reader:
        latents = final_latents_matrices_label(reader)
    kwargs = dict(final_latents_matrices_label=latents, blend_depth=BLEND_DEPTH,
                  time_series_audio_vectors=audio, vector_length=512, network_indices=[0, 1],
                  **BLEND)
    return (alpha_blend_projection_file(device="cpu", **kwargs),
            jax_alpha_blend_projection_file(**kwargs))


def test_flagship_matches_jax_on_broadband_audio(tmp_path, flagship_assets):
    a = flagship_assets
    port_inputs, jax_inputs = flagship_inputs(a, a["broadband"])
    np.testing.assert_allclose(port_inputs.combined.data, jax_inputs.combined.data,
                               rtol=0, atol=1e-4)
    indices = jax_inputs.network_indices.result.data
    np.testing.assert_array_equal(port_inputs.network_indices.result.data, indices)
    assert set(indices.tolist()) == {0, 1}
    frames, audio = port_flagship(a, a["broadband"], tmp_path / "port.avi")
    want = jax_flagship(a, a["broadband"], tmp_path / "jax.avi")
    # frame multiplier (10 / 5) x the file's 8 latents
    assert frames.shape == want.shape == (2 * PROJECTION_FRAMES, FLAGSHIP_SIDE, FLAGSHIP_SIDE, 3)
    np.testing.assert_array_equal(audio, wavfile.read(str(a["broadband"]))[1])
    steps = uint8_steps(frames, want)
    assert float(np.mean(steps <= 1)) >= 0.999, int(steps.max())


def test_flagship_matches_jax_on_percussive_audio(tmp_path, flagship_assets):
    a = flagship_assets
    frames, audio = port_flagship(a, a["percussive"], tmp_path / "port.avi")
    want = jax_flagship(a, a["percussive"], tmp_path / "jax.avi")
    np.testing.assert_array_equal(audio, wavfile.read(str(a["percussive"]))[1])
    steps = uint8_steps(frames, want)
    assert int(steps.max()) <= 2
    assert float(np.mean(steps <= 1)) >= 0.995


# per projection frame: the eye pair's x offset from the synthesized frame's
# (the bbox gate is 3 px), or None for no face; outputs repeat each twice
EYE_OFFSETS = [0, 1, 9, 2, None, 0, 1, 2]


def eye_points(x: int, y: int):
    return [(x, y), (x + 2, y - 1), (x + 4, y), (x + 2, y + 1)]


@pytest.mark.parametrize("music_mask", [False, True])
def test_flagship_overlay_decisions_match_jax(tmp_path, monkeypatch, flagship_assets,
                                              music_mask):
    import cv2

    a = flagship_assets
    with load_projection_file(a["projection"]) as reader:
        targets = [cv2.resize(t, (FLAGSHIP_SIDE, FLAGSHIP_SIDE), interpolation=cv2.INTER_CUBIC)
                   for t in reader.target_images]
    keys = {t.tobytes(): i for i, t in enumerate(targets)}

    def face_landmarks(self, face_image):
        index = keys.get(np.ascontiguousarray(face_image).tobytes())
        if index is not None and EYE_OFFSETS[index] is None:
            return []
        x = 6 + (0 if index is None else EYE_OFFSETS[index])
        return [{"left_eye": eye_points(x, 8), "right_eye": eye_points(x + 8, 8)}]

    decisions = {}
    for name, faces, module in (("jax", jax_faces, jax_pfb), ("port", port_faces, port_pfb)):
        monkeypatch.setattr(faces.FaceFinderProxy, "face_landmarks", face_landmarks)

        def recording(*args, _name=name, _inner=module.compute_eye_tracking_overlay, **kwargs):
            result = _inner(*args, **kwargs)
            decisions[_name] = []

            def boxes():
                for b in result.bbox_lists:
                    decisions[_name].append(None if b is None else [tuple(x) for x in b])
                    yield b

            return result._replace(bbox_lists=boxes())

        monkeypatch.setattr(module, "compute_eye_tracking_overlay", recording)
    overlay = dict(phash_distance=64, bbox_distance=3.0, track_length=3)
    if music_mask:
        audio = read_wavs_scale_for_video([a["percussive"]], 512, target_num_vectors=16).wav_data
        mask = music_complexity_mask(audio, 512, 2, device="cpu").result.data
        overlay.update(complexity_change_rolling_sum_window=2,
                       complexity_change_threshold=float(np.nanmedian(mask)))
    tee_dir = tmp_path / "tee"
    tee_dir.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tee_dir))
    frames, _ = port_flagship(a, a["percussive"], tmp_path / "port.avi", **overlay)
    assert not list(tee_dir.glob("gance_tpu_torch_tee_*"))  # both disk tees cleaned up
    want = jax_flagship(a, a["percussive"], tmp_path / "jax.avi", **overlay)
    assert decisions["port"] == decisions["jax"]
    boxes = decisions["port"]
    assert len(boxes) == len(frames) == 2 * PROJECTION_FRAMES
    detected = np.asarray([b is not None for b in boxes])
    kept = track_length_filter(detected, 3)
    assert kept.any() and (detected & ~kept).any()  # some composite, a short track does not
    if music_mask:
        assert not detected[0]  # the rolling sum's NaN warm-up skips
    steps = uint8_steps(frames, want)
    assert int(steps.max()) <= 2 and float(np.mean(steps <= 1)) >= 0.995
    for frame, target, frame_boxes, composited in zip(frames, np.repeat(targets, 2, axis=0),
                                                      boxes, kept):
        if composited:
            mask = port_common.draw_mask(port_common.image_resolution(frame), frame_boxes) > 0
            np.testing.assert_array_equal(frame[mask], target[mask])


def test_flagship_rejects_an_incomplete_file_as_jax_does(tmp_path, flagship_assets):
    a = dict(flagship_assets, projection=write_projection(tmp_path / "incomplete.hdf5",
                                                          frames=2, complete=False))
    for render in (jax_flagship, port_flagship):
        with pytest.raises(ValueError, match="Invalid Projection File, cannot continue."):
            render(a, a["percussive"], tmp_path / "x.avi")


def test_flagship_fps_must_divide_as_jax_requires(tmp_path, flagship_assets):
    a = flagship_assets
    for render in (jax_flagship, port_flagship):
        with pytest.raises(ValueError, match="not exact"):
            render(a, a["percussive"], tmp_path / "x.avi", output_fps=12.0)


def test_flagship_music_mask_without_overlay_raises_as_jax_does(tmp_path, flagship_assets):
    a = flagship_assets
    mask = dict(complexity_change_rolling_sum_window=2, complexity_change_threshold=0.5)
    messages = []
    for render in (jax_flagship, port_flagship):
        with pytest.raises(ValueError) as error:
            render(a, a["percussive"], tmp_path / "x.avi", **mask)
        messages.append(str(error.value))
    assert messages[0] == messages[1] and "without overlay" in messages[0]


@pytest.mark.parametrize("kwargs,item", [
    ({"data_parallel": 2}, "item 12"), ({"device_per_network": True}, "item 12"),
    ({"network_parallel": True}, "item 12"), ({"debug_path": Path("d.avi")}, "item 13"),
    ({"resumable": True, "debug_path": Path("d.avi")}, "debug visualization"),
])
def test_flagship_deferred_options_raise(tmp_path, flagship_assets, kwargs, item, monkeypatch):
    """The flagship's placements (item 12, part 1) render over two CPU slots
    the frames of the default placement; the debug video (item 13) renders
    the hero video's frames as [blended | final image | synthesis panel]
    without the overlay, and a resumable render still refuses it."""
    a = flagship_assets
    if item == "item 13":
        hero, _ = port_flagship(a, a["percussive"], tmp_path / "x.avi", frames_to_visualize=8,
                                debug_path=tmp_path / kwargs["debug_path"], debug_window=10,
                                debug_side_length=32)
        with pytest.MonkeyPatch.context() as patch:
            hide_encoders(patch)
            debug = read_avi(tmp_path / "d.avi")[0]
        assert hero.shape == (8, FLAGSHIP_SIDE, FLAGSHIP_SIDE, 3)
        assert debug.shape == (8, 32, 3 * 32, 3)
        return
    if item != "item 12":
        with pytest.raises((NotImplementedError, ValueError), match=item):
            port_flagship(a, a["percussive"], tmp_path / "x.avi", **kwargs)
        return
    cpu_slots(2, monkeypatch)
    want, _ = port_flagship(a, a["percussive"], tmp_path / "plain.avi", frames_to_visualize=8)
    got, _ = port_flagship(a, a["percussive"], tmp_path / "x.avi", frames_to_visualize=8,
                           **kwargs)
    assert_most_within_one_step(got, want)


def test_flagship_defaults_to_cuda_and_raises_without_it(tmp_path, flagship_assets):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        port_pfb.projection_file_blend_api(
            output_path=tmp_path / "x.avi",
            **flagship_args(flagship_assets, flagship_assets["percussive"]))


def test_cli_projection_file_blend(tmp_path, flagship_assets, no_encoders):
    a = flagship_assets
    out = tmp_path / "cli.avi"
    common = ["projection-file-blend", "--wav", str(a["percussive"]), "--output-path", str(out),
              "--networks-directory", str(a["paths"][0].parent), "--projection-file-path",
              str(a["projection"]), "--output-fps", str(FLAGSHIP_FPS), "--output-side-length",
              str(FLAGSHIP_SIDE), "--device", "cpu"]
    result = CliRunner().invoke(cli, common + [
        "--blend-depth", "3", "--frames-to-visualize", "5", "--phash-distance", "30",
        "--bbox-distance", "50", "--track-length", "2", "--overlay-detection-side", "32"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    frames, audio, _ = read_avi(out)
    assert frames.shape == (5, FLAGSHIP_SIDE, FLAGSHIP_SIDE, 3)
    np.testing.assert_array_equal(audio, wavfile.read(str(a["percussive"]))[1])
    partial = CliRunner().invoke(cli, common + ["--phash-distance", "30"])
    assert partial.exit_code != 0 and "must be given together" in partial.output
    depth = CliRunner().invoke(cli, common + ["--blend-depth", "19"])
    assert depth.exit_code != 0
    resumable = CliRunner().invoke(cli, common + ["--resumable", "--debug-path", "d.avi"])
    assert isinstance(resumable.exception, ValueError) and "debug" in str(resumable.exception)
