"""
Resumable renders of the port's two pipelines on the CPU: each is killed with
SIGKILL in a child process (`device="cpu"`, GANCE_TPU_EGRESS=raw-spill, so
the parts are raw and the output is one raw AVI with the audio), then resumed
in this process.

- noise-blend: two 16px networks, a 2 s percussive WAV at 10 fps (20
  frames), chunks of 16 (one stream window), killed once a chunk is durable;
- the flagship: a projection file of 8 frames at 5 fps rendered at 10 fps
  and side 24, the overlay on with temporal smoothing over 3 frames, the
  landmark finder replaced by a fake keyed on the scaled targets (random
  weights give no faces), killed during detection once the decision sidecar
  holds a decision.

The resumed output equals the port's unbroken resumable render bit for bit,
the resumed run synthesizes only from the stream window at or before the
first frame it needs, and the scaffolding is gone. Against JAX's resumable render of the same inputs
(its frames recorded where its finalize writes them), the frames lie within
the bounds of tests/test_torch_pipelines.py: noise-blend max 2 uint8 steps
and 99.5% within 1 (the port's float64 spectrogram), the flagship on a
broadband WAV 1 step on 99.9%.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("cv2")

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from gance_tpu.media import resume as jax_resume  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.overlay import faces as jax_faces  # noqa: E402
from gance_tpu.pipelines import noise_blend as jax_noise_blend  # noqa: E402
from gance_tpu.pipelines import projection_file_blend as jax_pfb  # noqa: E402
from gance_tpu_torch.audio.io import fabricate_percussive_wav  # noqa: E402
from gance_tpu_torch.media import resume  # noqa: E402
from gance_tpu_torch.overlay import faces as port_faces  # noqa: E402
from gance_tpu_torch.pipelines import noise_blend as port_noise_blend  # noqa: E402
from gance_tpu_torch.pipelines import projection_file_blend as port_pfb  # noqa: E402
from gance_tpu_torch.synthesis import orchestration  # noqa: E402
from tests.test_torch_media import read_avi  # noqa: E402
from tests.test_torch_pipelines import init_params, uint8_steps, write_projection  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BLEND = dict(alpha=0.25, fft_roll_enabled=False, fft_amplitude_range=(-1.0, 1.0))
NOISE_FPS, NOISE_FRAMES = 10.0, 20
WINDOW = 16  # the synthesis stream's window: batch 8 x lookahead 2
FLAGSHIP_FPS, FLAGSHIP_SIDE, FLAGSHIP_FRAMES = 10.0, 24, 16
OVERLAY = dict(phash_distance=64, bbox_distance=3.0, track_length=2, overlay_smoothing=3)

# The fake landmark finder, run in this process and in the children: eyes on
# a scaled projection target move with the target's index, a target of
# index 4 has no face, and any other image has eyes at x = 6.
FAKE_FINDER = """
import numpy as np
from gance_tpu_torch.projection import load_projection_file

def fake_landmarks(projection, side):
    import cv2
    with load_projection_file(projection) as reader:
        keys = {cv2.resize(t, (side, side), interpolation=cv2.INTER_CUBIC).tobytes(): i
                for i, t in enumerate(reader.target_images)}

    def eyes(x, y):
        return [(x, y), (x + 2, y - 1), (x + 4, y), (x + 2, y + 1)]

    def face_landmarks(self, face_image):
        index = keys.get(np.ascontiguousarray(face_image).tobytes())
        if index == 4:
            return []
        x = 6 + (0 if index is None else [0, 1, 9, 2, 0, 0, 1, 2][index])
        return [{"left_eye": eyes(x, 8), "right_eye": eyes(x + 8, 8)}]

    return face_landmarks
"""
_namespace: dict = {}
exec(FAKE_FINDER, _namespace)  # pylint: disable=exec-used
fake_landmarks = _namespace["fake_landmarks"]

CHILD = """
import json, sys
from pathlib import Path
args = json.loads(sys.argv[1])
if args["pipeline"] == "noise_blend":
    from gance_tpu_torch.pipelines.noise_blend import noise_blend_api as api
else:
    from gance_tpu_torch.overlay import faces
    from gance_tpu_torch.pipelines.projection_file_blend import projection_file_blend_api as api
    faces.FaceFinderProxy.face_landmarks = fake_landmarks(
        Path(args["kwargs"]["projection_file_path"]), args["side"])
kwargs = args["kwargs"]
for key in ("output_path", "projection_file_path"):
    if key in kwargs:
        kwargs[key] = Path(kwargs[key])
api(wav=[Path(p) for p in kwargs.pop("wav")],
    network_paths=[Path(p) for p in kwargs.pop("network_paths")], **kwargs)
"""


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume_pipelines")
    paths = []
    for i in range(2):
        paths.append(d / f"{i}_net.pkl")
        save_generator_pickle(init_params(i), paths[-1])
    rate = 44100
    noise = np.random.RandomState(23).uniform(-0.5, 0.5, rate * 2)
    broadband = d / "broadband.wav"
    wavfile.write(str(broadband), rate, (noise * 32767).astype(np.int16))
    return dict(paths=paths, percussive=fabricate_percussive_wav(d / "song.wav", seconds=2.0),
                broadband=broadband, projection=write_projection(d / "projection.hdf5"))


@pytest.fixture()
def raw_egress(monkeypatch):
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")


def noise_blend_kwargs(a: dict, out: Path) -> dict:
    return dict(wav=[str(a["percussive"])], output_path=str(out),
                network_paths=[str(p) for p in a["paths"]], frames_to_visualize=None,
                output_fps=NOISE_FPS, output_side_length=16, debug_path=None,
                debug_window=None, debug_side_length=None, resumable=True,
                resume_chunk_frames=WINDOW, **BLEND)


def flagship_kwargs(a: dict, out: Path) -> dict:
    return dict(wav=[str(a["broadband"])], output_path=str(out),
                network_paths=[str(p) for p in a["paths"]], frames_to_visualize=None,
                output_fps=FLAGSHIP_FPS, output_side_length=FLAGSHIP_SIDE, debug_path=None,
                debug_window=None, debug_side_length=None,
                projection_file_path=str(a["projection"]), blend_depth=4, resumable=True,
                resume_chunk_frames=4, **OVERLAY, **BLEND)


def port_api(pipeline: str, kwargs: dict) -> None:
    kwargs = dict(kwargs, wav=[Path(p) for p in kwargs["wav"]], output_path=Path(kwargs["output_path"]),
                  network_paths=[Path(p) for p in kwargs["network_paths"]])
    if pipeline == "noise_blend":
        port_noise_blend.noise_blend_api(device="cpu", **kwargs)
    else:
        port_pfb.projection_file_blend_api(device="cpu", **kwargs)


def kill_when(pipeline: str, kwargs: dict, ready, env: dict, log: Path,
              timeout: float = 120.0) -> None:
    """Run the pipeline in a child (its output into `log`) and SIGKILL it once
    `ready()` holds."""
    code = FAKE_FINDER + CHILD
    args = json.dumps({"pipeline": pipeline, "kwargs": dict(kwargs, device="cpu"),
                       "side": FLAGSHIP_SIDE})
    with open(log, "wb") as output:
        child = subprocess.Popen([sys.executable, "-c", code, args], cwd=ROOT,
                                 env={**os.environ, "GANCE_TPU_EGRESS": "raw-spill", **env},
                                 stdout=output, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if child.poll() is not None:
                raise AssertionError("the render ended before it could be killed:\n"
                                     + log.read_text(errors="replace"))
            if ready():
                os.kill(child.pid, signal.SIGKILL)
                child.wait()
                return
            time.sleep(0.02)
        raise AssertionError("the render never reached the point to kill it:\n"
                             + log.read_text(errors="replace"))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def chunks_durable(output: Path) -> bool:
    try:
        return bool(json.loads(resume.manifest_path(output).read_text())["chunks"])
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def jax_resumable_frames(monkeypatch, render) -> np.ndarray:
    """JAX's resumable render, its frames recorded where its finalize writes."""
    frames = []

    def record(source, **_):
        for frame in source:
            frames.append(np.array(frame))
            yield frame

    with monkeypatch.context() as patch:
        patch.setattr(jax_resume, "write_source_to_disk_forward", record)
        render()
    return np.stack(frames)


def count_synthesized(monkeypatch) -> list:
    """Record the frame count of each resumed render's synthesis."""
    counts = []
    inner = orchestration.vector_synthesis

    def counting(*args, **kwargs):
        counts.append(kwargs["frames_to_visualize"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(orchestration, "vector_synthesis", counting)
    return counts


def test_noise_blend_kill9_resume(tmp_path, monkeypatch, assets, raw_egress):
    unbroken = tmp_path / "unbroken.avi"
    port_api("noise_blend", noise_blend_kwargs(assets, unbroken))
    want, audio, _ = read_avi(unbroken)
    assert want.shape == (NOISE_FRAMES, 16, 16, 3)

    killed = tmp_path / "killed.avi"
    kwargs = noise_blend_kwargs(assets, killed)
    kill_when("noise_blend", kwargs, lambda: chunks_durable(killed),
              {"GANCE_TPU_RESUME_CHUNK_DELAY": "5"}, tmp_path / "child.log")
    assert not killed.exists()
    durable = resume.durable_frames(killed, json.loads(
        resume.manifest_path(killed).read_text())["fingerprint"])
    assert durable == WINDOW
    counts = count_synthesized(monkeypatch)
    port_api("noise_blend", kwargs)
    assert counts == [NOISE_FRAMES - durable]  # finished frames are skipped
    assert not resume.manifest_path(killed).exists() and not resume.parts_directory(killed).exists()
    got, got_audio, _ = read_avi(killed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_audio, wavfile.read(str(assets["percussive"]))[1])
    np.testing.assert_array_equal(audio, got_audio)

    jax_kwargs = dict(noise_blend_kwargs(assets, tmp_path / "jax.avi"),
                      wav=[assets["percussive"]], network_paths=assets["paths"],
                      output_path=tmp_path / "jax.avi")
    jax = jax_resumable_frames(monkeypatch, lambda: jax_noise_blend.noise_blend_api(**jax_kwargs))
    steps = uint8_steps(got, jax)
    assert int(steps.max()) <= 2 and float(np.mean(steps <= 1)) >= 0.995, int(steps.max())


def test_flagship_kill9_during_detection_resume(tmp_path, monkeypatch, assets, raw_egress):
    monkeypatch.setattr(port_faces.FaceFinderProxy, "face_landmarks",
                        fake_landmarks(assets["projection"], FLAGSHIP_SIDE))
    unbroken = tmp_path / "unbroken.avi"
    decisions = []
    inner = port_pfb.compute_eye_tracking_overlay

    def recording(*args, **kwargs):
        result = inner(*args, **kwargs)

        def boxes():
            for b in result.bbox_lists:
                decisions.append(b)
                yield b

        return result._replace(bbox_lists=boxes())

    with monkeypatch.context() as patch:
        patch.setattr(port_pfb, "compute_eye_tracking_overlay", recording)
        port_api("flagship", flagship_kwargs(assets, unbroken))
    want = read_avi(unbroken)[0]
    assert want.shape == (FLAGSHIP_FRAMES, FLAGSHIP_SIDE, FLAGSHIP_SIDE, 3)
    detected = [b is not None for b in decisions]
    assert any(detected) and not all(detected)  # the fake finder's faces gate both ways

    killed = tmp_path / "killed.avi"
    sidecar = port_pfb._overlay_decisions_path(killed)

    def decided() -> bool:
        return sidecar.exists() and len(sidecar.read_text().splitlines()) >= 3

    kwargs = flagship_kwargs(assets, killed)
    kill_when("flagship", kwargs, decided, {"GANCE_TPU_RESUME_DECISION_DELAY": "0.3"},
              tmp_path / "child.log")
    fingerprint = json.loads(sidecar.read_text().splitlines()[0])["fingerprint"]
    cached = len(port_pfb._load_overlay_decisions(sidecar, fingerprint))
    assert 2 <= cached < FLAGSHIP_FRAMES and not resume.manifest_path(killed).exists()
    counts = count_synthesized(monkeypatch)
    port_api("flagship", kwargs)
    # detection resumes `cached` frames in, after a replay of the smoothing
    # window; synthesis at the stream window at or before that
    detect_from = cached - min(cached, OVERLAY["overlay_smoothing"])
    assert counts == [FLAGSHIP_FRAMES - (detect_from - detect_from % WINDOW)]
    assert not sidecar.exists() and not resume.manifest_path(killed).exists()
    assert not resume.parts_directory(killed).exists()
    got, audio, _ = read_avi(killed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio, wavfile.read(str(assets["broadband"]))[1])

    monkeypatch.setattr(jax_faces.FaceFinderProxy, "face_landmarks",
                        fake_landmarks(assets["projection"], FLAGSHIP_SIDE))
    jax_kwargs = dict(flagship_kwargs(assets, tmp_path / "jax.avi"), wav=[assets["broadband"]],
                      network_paths=assets["paths"], output_path=tmp_path / "jax.avi")
    jax = jax_resumable_frames(monkeypatch,
                               lambda: jax_pfb.projection_file_blend_api(**jax_kwargs))
    steps = uint8_steps(got, jax)
    assert float(np.mean(steps <= 1)) >= 0.999, int(steps.max())


@pytest.mark.parametrize("pipeline", ["noise_blend", "flagship"])
def test_resumable_refuses_the_debug_video_and_a_process_group(tmp_path, assets, monkeypatch,
                                                               pipeline):
    make = noise_blend_kwargs if pipeline == "noise_blend" else flagship_kwargs
    kwargs = dict(make(assets, tmp_path / "x.avi"), debug_path=str(tmp_path / "debug.avi"))
    with pytest.raises(ValueError, match="debug visualization"):
        port_api(pipeline, kwargs)
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="single-process only"):
        port_api(pipeline, make(assets, tmp_path / "x.avi"))
    assert not list(tmp_path.iterdir())
