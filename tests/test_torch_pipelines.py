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
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from click.testing import CliRunner  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from gance_tpu.audio.io import read_wavs_scale_for_video as jax_read_wavs  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.synthesis.inputs import (  # noqa: E402
    alpha_blend_vectors_max_rms_power_audio as jax_alpha_blend,
)
from gance_tpu.synthesis.orchestration import vector_synthesis as jax_vector_synthesis  # noqa: E402
from gance_tpu.synthesis.runtime import MultiNetwork as JaxMultiNetwork  # noqa: E402
from gance_tpu_torch.audio.io import fabricate_percussive_wav, read_wavs_scale_for_video  # noqa: E402
from gance_tpu_torch.cli.music_into_networks import cli  # noqa: E402
from gance_tpu_torch.media import video  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.pipelines.noise_blend import noise_blend_api  # noqa: E402
from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio  # noqa: E402
from gance_tpu_torch.synthesis.runtime import params_to_device  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402

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
                                    ["--data-parallel", "2"], ["--resumable"],
                                    ["--debug-path", "debug.avi"]])
def test_cli_deferred_options_raise(tmp_path, assets, option):
    paths, wav = assets
    result = CliRunner().invoke(cli, [
        "noise-blend", "--wav", str(wav), "--output-path", str(tmp_path / "x.avi"),
        "--network-path", str(paths[0]), "--device", "cpu", *option])
    assert isinstance(result.exception, NotImplementedError), result.output
    assert "ROADMAP.md Queue 1 item" in str(result.exception)


@pytest.mark.parametrize("kwargs,item", [
    ({"data_parallel": 2}, "item 12"), ({"device_per_network": True}, "item 12"),
    ({"network_parallel": True}, "item 12"), ({"debug_path": Path("d.avi")}, "item 13"),
    ({"resumable": True}, "item 2"),
])
def test_deferred_options_raise(tmp_path, assets, kwargs, item):
    paths, wav = assets
    with pytest.raises(NotImplementedError, match=item):
        render(paths, wav, tmp_path / "x.avi", **kwargs)


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
