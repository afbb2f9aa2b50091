"""
The port's audio serving (gance_tpu_torch/serving/audio.py and the daemon's
/synthesize_audio route) against gance_tpu's, on the CPU, the same request to
both over each package's FakeSynthesisNetworks (vector length 512, whose RMS
hop keeps the index and frame counts equal):
- on broadband audio (seeded noise: every FFT bin well above float32 noise)
  the plans' indices are equal and their rows within 1e-4, for noise-blend
  and for the flagship blend from posted latents and from an HDF5 file that
  JAX's writer wrote;
- on the percussive track the indices are equal and the rows within the
  float32 floor of ROADMAP's PR 8 departure (the port's spectrogram FFT is
  float64): 5e-2, as tests/test_torch_audio.py holds it;
- the overlay route (format avi) with a fake landmark finder patched into
  both packages composites the same frames;
- `synthesize_plan` scatters each network group back to frame order;
- the three defects of JAX's audio serving that ADVICE.md names are absent
  from the port, each shown beside JAX's behaviour.
"""

import base64
import io
import json
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from gance_tpu.audio.io import fabricate_percussive_wav  # noqa: E402
from gance_tpu.serving import audio as jax_audio  # noqa: E402
from gance_tpu.serving import daemon as jax_daemon  # noqa: E402
from gance_tpu.synthesis import runtime as jax_rt  # noqa: E402
from gance_tpu_torch.serving import audio as port_audio  # noqa: E402
from gance_tpu_torch.serving import daemon as port_daemon  # noqa: E402
from gance_tpu_torch.synthesis import runtime as port_rt  # noqa: E402

VECTOR = 512
ROWS = 6  # style rows of a 16px generator
FPS = 15.0
BROADBAND_TOLERANCE = 1e-4
# ROADMAP's PR 8 departure: the port's noise-blend inputs lie 1.03e-2 to
# 3.74e-2 from JAX's on the percussive track (tests/test_torch_audio.py)
PERCUSSIVE_TOLERANCE = 5e-2
PACKAGES = {"jax": (jax_audio, jax_daemon, jax_rt), "port": (port_audio, port_daemon, port_rt)}


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rate = 44100
    noise = np.random.RandomState(23).uniform(-0.5, 0.5, rate)
    wavfile.write(str(d / "broadband.wav"), rate, (noise * 32767).astype(np.int16))
    fabricate_percussive_wav(d / "percussive.wav", seconds=1.0)
    return {name: (d / f"{name}.wav").read_bytes() for name in ("broadband", "percussive")}


def fakes(runtime, count: int = 2, resolution: int = 16):
    out = []
    for index in range(count):
        fake = runtime.FakeSynthesisNetwork(resolution=resolution, expected_vector_length=VECTOR)
        fake.path = Path(f"/nets/{index}_net.pkl")
        out.append(fake)
    return out


def payload(wav: bytes, **extra) -> dict:
    body = {"wav_base64": base64.b64encode(wav).decode(), "fps": FPS}
    body.update(extra)
    return body


def final_latents(frames: int = 8, seed: int = 4, rows: int = ROWS) -> np.ndarray:
    """Rows-identical (frames, rows, 512) latents, as the projector writes them."""
    latents = np.random.RandomState(seed).randn(frames, 1, VECTOR).astype(np.float32)
    return np.tile(latents, (1, rows, 1))


def plans(wav: bytes, projection_latents=None, **extra):
    """Each package's plan of the same request over its own fakes."""
    out = {}
    for pkg, (audio, _daemon, runtime) in PACKAGES.items():
        projection = None
        if projection_latents is not None:
            projection = audio.registration_from_latents(projection_latents, FPS, "p")
        out[pkg] = audio.plan_audio_request(payload(wav, **extra), fakes(runtime), [0, 1], 4096,
                                            projection=projection)
    return out["port"], out["jax"]


@pytest.mark.parametrize("roll", [False, True])
def test_noise_blend_plan_matches_jax_on_broadband_audio(wavs, roll):
    got, want = plans(wavs["broadband"], alpha=0.4, fft_roll=roll)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert set(want.indices.tolist()) == {0, 1}
    np.testing.assert_allclose(got.combined, want.combined, rtol=0, atol=BROADBAND_TOLERANCE)
    assert (got.fps, got.vector_length, got.selected, got.frame_multiplier) == \
        (want.fps, want.vector_length, want.selected, want.frame_multiplier)


def test_noise_blend_plan_on_percussive_audio_within_the_float32_floor(wavs):
    # the floor was measured at the offline pipeline's alpha and amplitude
    # range; it scales with both (the spectrogram's share of each row)
    got, want = plans(wavs["percussive"], alpha=0.25, fft_amplitude_range=[-1.0, 1.0])
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.combined, want.combined, rtol=0, atol=PERCUSSIVE_TOLERANCE)


@pytest.mark.parametrize("depth", [0, 3, ROWS])
def test_flagship_plan_from_latents_matches_jax(wavs, depth):
    got, want = plans(wavs["broadband"], final_latents(), blend_depth=depth)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.combined, want.combined, rtol=0, atol=BROADBAND_TOLERANCE)
    assert got.combined.shape == (8, ROWS, VECTOR)
    assert (got.blend_depth, got.frame_multiplier, got.projection) == (depth, 1, "p")


def write_projection(path: Path, latents: np.ndarray, targets: np.ndarray) -> Path:
    """A projection file written by JAX's ProjectionFileWriter."""
    from gance_tpu.projection.file_writer import ProjectionFileWriter
    from gance_tpu.projection.projection_types import LATEST_VERSION, ProjectionAttributes

    frames, side = latents.shape[0], targets.shape[1]
    attrs = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=False, original_target_path="t",
        original_width_height=(side, side), projection_width_height=(side, side),
        target_md5_hash="0" * 32, original_network_path="n", network_md5_hash="0" * 32,
        steps_in_projection=1, noises_shapes=np.nan, latents_histories_enabled=False,
        noises_histories_enabled=False, images_histories_enabled=False, original_fps=FPS,
        projection_fps=FPS, original_frame_count=frames, projection_frame_count=frames)
    writer = ProjectionFileWriter(path, attrs)
    for index in range(frames):
        with writer.frame_writer() as frame:
            frame.finish(targets[index], latents[index][None], targets[index])
    writer.close(complete=True)
    return path


def smooth_targets(frames: int, side: int, seed: int = 9) -> np.ndarray:
    import cv2

    rng = np.random.RandomState(seed)
    return np.stack([cv2.resize((rng.rand(4, 4, 3) * 255).astype(np.uint8), (side, side),
                                interpolation=cv2.INTER_CUBIC) for _ in range(frames)])


def test_flagship_plan_from_a_jax_written_file_matches_jax(wavs, tmp_path):
    path = write_projection(tmp_path / "p.hdf5", final_latents(), smooth_targets(8, 32))
    regs = {pkg: audio.load_projection_registration(str(path))
            for pkg, (audio, _d, _r) in PACKAGES.items()}
    for field in ("name", "vector_length", "num_rows", "projection_fps", "frame_count", "label",
                  "path", "content_hash"):
        assert getattr(regs["port"], field) == getattr(regs["jax"], field), field
    np.testing.assert_array_equal(regs["port"].matrices, regs["jax"].matrices)
    got, want = (PACKAGES[pkg][0].plan_audio_request(
        payload(wavs["broadband"], fps=30.0, blend_depth=4), fakes(PACKAGES[pkg][2]), [0, 1],
        4096, projection=regs[pkg]) for pkg in ("port", "jax"))
    assert got.frame_multiplier == want.frame_multiplier == 2
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.combined, want.combined, rtol=0, atol=BROADBAND_TOLERANCE)


def test_network_groups_and_synthesize_plan_scatter_order():
    indices = np.random.RandomState(5).randint(0, 3, 40)
    got, want = port_audio._network_groups(indices), jax_audio._network_groups(indices)
    assert [(i, p.tolist()) for i, p in got] == [(i, p.tolist()) for i, p in want]
    combined = np.random.RandomState(6).randn(40, VECTOR).astype(np.float32)
    outputs = {}
    for pkg, (audio, _daemon, runtime) in PACKAGES.items():
        plan = audio.AudioSynthesisPlan(combined=combined, indices=indices, selected=[0, 1, 2],
                                        fps=FPS, vector_length=VECTOR, wav_bytes=b"")
        batcher_mod = __import__(f"{'gance_tpu' if pkg == 'jax' else 'gance_tpu_torch'}"
                                 ".serving.batcher", fromlist=["DynamicBatcher"])
        networks = fakes(runtime, 3)
        with batcher_mod.DynamicBatcher(networks, max_batch=8, max_delay_ms=0) as batcher:
            outputs[pkg] = audio.synthesize_plan(batcher, plan, timeout_s=60)
            frames_by_network = batcher.stats()["frames_by_network"]
        assert frames_by_network == np.bincount(indices, minlength=3).tolist()
    np.testing.assert_array_equal(outputs["port"], outputs["jax"])
    # frame i is the render of row i (each fake renders its row's mean)
    np.testing.assert_array_equal(outputs["port"], fakes(port_rt, 1)[0]._render(combined))


def call(daemon, path: str, body: dict):
    request = urllib.request.Request(f"http://127.0.0.1:{daemon.port}{path}",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=120) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as error:
        return error.code, error.read()


@pytest.fixture(scope="module")
def daemons():
    opened = {pkg: d.SynthesisDaemon(fakes(r), port=0, max_batch=8, max_delay_ms=0)
              for pkg, (_a, d, r) in PACKAGES.items()}
    for daemon in opened.values():
        daemon.start()
    yield opened
    for daemon in opened.values():
        daemon.stop()


def test_daemon_audio_plan_preview_and_frames_match_jax(wavs, daemons):
    body = payload(wavs["broadband"], alpha=0.3)
    previews = {pkg: json.loads(call(d, "/synthesize_audio", dict(body, plan=True))[1])
                for pkg, d in daemons.items()}
    assert previews["port"] == previews["jax"]
    frames = {}
    for pkg, daemon in daemons.items():
        status, blob = call(daemon, "/synthesize_audio", body)
        assert status == 200
        frames[pkg] = np.load(io.BytesIO(blob))
    assert frames["port"].shape == frames["jax"].shape == (15, 16, 16, 3)
    assert int(np.abs(frames["port"].astype(int) - frames["jax"].astype(int)).max()) <= 1


AUDIO_ERRORS = {
    "fps": {"fps": 0},
    "alpha": {"alpha": 2},
    "amplitude range": {"fft_amplitude_range": [1]},
    "palette repeats": {"networks": [0, 0]},
    "palette unknown": {"networks": ["nope"]},
    "overlay without avi": {"overlay": {"phash_distance": 1, "bbox_distance": 1,
                                        "track_length": 1}},
    "unknown projection": {"projection": "missing"},
    "frame cap": {"fps": 240},
}


@pytest.mark.parametrize("case", sorted(AUDIO_ERRORS))
def test_daemon_audio_error_statuses_match_jax(wavs, daemons, case):
    body = payload(wavs["broadband"], **AUDIO_ERRORS[case])
    if case == "frame cap":
        for daemon in daemons.values():
            daemon.frame_caps = [200, 200]
    try:
        statuses = {pkg: call(d, "/synthesize_audio", body)[0] for pkg, d in daemons.items()}
    finally:
        for daemon in daemons.values():
            daemon.frame_caps = [4096, 4096]
    assert statuses["port"] == statuses["jax"] == 400


# ---- the overlay route, with one fake landmark finder patched into both packages

EYE_OFFSETS = [0, 1, 9, 2, None, 0, 1, 2]  # per projection frame; the bbox gate is 3 px


def eye_points(x: int, y: int):
    return [(x, y), (x + 2, y - 1), (x + 4, y), (x + 2, y + 1)]


def test_overlay_route_composites_as_jax(wavs, tmp_path, monkeypatch):
    import cv2

    from gance_tpu.overlay import faces as jax_faces
    from gance_tpu_torch.media.native import raw_avi_frames
    from gance_tpu_torch.overlay import faces as port_faces

    side = 32  # 8 style rows
    targets = smooth_targets(8, 48)
    path = write_projection(tmp_path / "faces.hdf5", final_latents(rows=8), targets)
    scaled = [cv2.resize(t, (side, side), interpolation=cv2.INTER_CUBIC) for t in targets]
    keys = {t.tobytes(): i for i, t in enumerate(scaled)}

    def face_landmarks(self, face_image):
        index = keys.get(np.ascontiguousarray(face_image).tobytes())
        if index is not None and EYE_OFFSETS[index] is None:
            return []
        x = 6 + (0 if index is None else EYE_OFFSETS[index])
        return [{"left_eye": eye_points(x, 8), "right_eye": eye_points(x + 8, 8)}]

    for faces in (jax_faces, port_faces):
        monkeypatch.setattr(faces.FaceFinderProxy, "face_landmarks", face_landmarks)
    overlay = {"phash_distance": 64, "bbox_distance": 3.0, "track_length": 2}
    rendered = np.stack([np.full((side, side, 3), 40 + 10 * i, np.uint8) for i in range(8)])
    composited = {}
    for pkg, (audio, _daemon, _runtime) in PACKAGES.items():
        registration = audio.load_projection_registration(str(path))
        composited[pkg] = audio.composite_overlay(
            rendered, registration, 1, audio.parse_overlay_params({"overlay": overlay}))
    np.testing.assert_array_equal(composited["port"], composited["jax"])
    changed = [not np.array_equal(a, b) for a, b in zip(composited["port"], rendered)]
    assert any(changed) and not all(changed)

    # the daemon's route: register the file, ask for the avi with the overlay
    network = port_rt.FakeSynthesisNetwork(resolution=side, expected_vector_length=VECTOR)
    monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
    with port_daemon.SynthesisDaemon(network, port=0, max_batch=8, max_delay_ms=0) as daemon:
        assert call(daemon, "/admin/register_projection", {"path": str(path)})[0] == 200
        status, blob = call(daemon, "/synthesize_audio", payload(
            wavs["broadband"], format="avi", projection="faces", overlay=overlay))
        assert status == 200
        plan = port_audio.plan_audio_request(
            payload(wavs["broadband"], projection="faces"), [network], [0], 4096,
            projection=daemon.projections["faces"])
    avi = tmp_path / "served.avi"
    avi.write_bytes(blob)
    frames = np.stack(list(raw_avi_frames(avi)))
    want = port_audio.composite_overlay(
        network.images_from_matrices(plan.combined), daemon.projections["faces"], 1,
        port_audio.parse_overlay_params({"overlay": overlay}))
    np.testing.assert_array_equal(frames, want)


# ---- the three defects of JAX's audio serving (ADVICE.md), kept out of the port


def test_plan_cache_hands_out_read_only_arrays(wavs):
    writable = {}
    for pkg, (audio, _daemon, runtime) in PACKAGES.items():
        cache = audio.PlanCache()
        miss = audio.plan_audio_request(payload(wavs["broadband"]), fakes(runtime), [0, 1], 4096,
                                        plan_cache=cache)
        hit = audio.plan_audio_request(payload(wavs["broadband"]), fakes(runtime), [0, 1], 4096,
                                       plan_cache=cache)
        assert cache.stats()["hits"] == 1
        writable[pkg] = (miss.combined.flags.writeable, hit.combined.flags.writeable)
    assert writable == {"jax": (True, True), "port": (False, False)}
    with pytest.raises(ValueError, match="read-only"):
        hit.combined[0, 0] = 0.0


def test_file_registration_refuses_row_distinct_latents(tmp_path):
    latents = final_latents()
    latents[:, 3] += 1.0  # style-mixed: row 3 differs from row 0
    path = write_projection(tmp_path / "mixed.hdf5", latents, smooth_targets(8, 16))
    assert jax_audio.load_projection_registration(str(path)).num_rows == ROWS
    with pytest.raises(port_audio.AudioRequestError, match="identical style rows"):
        port_audio.load_projection_registration(str(path))
    # posted latents meet the same gate in both packages
    for audio in (jax_audio, port_audio):
        with pytest.raises(audio.AudioRequestError, match="identical style rows"):
            audio.registration_from_latents(latents, FPS, "mixed")


def test_frame_cap_holds_on_a_plan_cache_hit(wavs):
    """The 1 s clip at 15 fps plans 15 frames; a cap of 14 passes the
    estimate's slack (14 x 1.05 + 2) but not the exact count. A miss is
    refused in both packages; JAX serves the cached plan, the port refuses."""
    served = {}
    for pkg, (audio, _daemon, runtime) in PACKAGES.items():
        networks, cache = fakes(runtime), audio.PlanCache()
        with pytest.raises(audio.AudioRequestError, match="exceeds"):
            audio.plan_audio_request(payload(wavs["broadband"]), networks, [0, 1], 14)
        assert audio.plan_audio_request(payload(wavs["broadband"]), networks, [0, 1], 4096,
                                        plan_cache=cache).indices.shape == (15,)
        try:
            served[pkg] = audio.plan_audio_request(payload(wavs["broadband"]), networks, [0, 1],
                                                   14, plan_cache=cache).indices.shape[0]
        except audio.AudioRequestError as error:
            served[pkg] = str(error)
    assert served["jax"] == 15
    assert "exceeds the per-request cap of 14" in served["port"]
