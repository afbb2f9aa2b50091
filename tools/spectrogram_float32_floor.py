#!/usr/bin/env python3
"""
How far gance_tpu's float32 spectrogram lies from a float64 derivation of
the same algorithm, against the port's (whose FFT stage is float64), on the
percussive test track and on broadband noise; how far the port's noise-blend
inputs lie from JAX's, roll off and on; and what that does to the
noise-blend frames of two 16px networks. These readings set the fixed
bounds of tests/test_torch_audio.py and tests/test_torch_pipelines.py.

    JAX_PLATFORMS=cpu python tools/spectrogram_float32_floor.py

Runs on the CPU (both packages); prints one line per case.
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))


def main() -> None:
    import jax

    from gance_tpu.audio import spectrogram as jax_spectrogram
    from gance_tpu.audio.io import read_wavs_scale_for_video
    from gance_tpu.models import stylegan2 as jax_g
    from gance_tpu.models.pickle_loader import save_generator_pickle
    from gance_tpu.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio as jax_blend
    from gance_tpu.synthesis.orchestration import vector_synthesis
    from gance_tpu.synthesis.runtime import MultiNetwork
    from gance_tpu_torch.audio import spectrogram
    from gance_tpu_torch.audio.io import fabricate_percussive_wav
    from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
    from gance_tpu_torch.synthesis.orchestration import vector_synthesis as port_vector_synthesis
    from gance_tpu_torch.synthesis.runtime import MultiNetwork as PortMultiNetwork
    from test_torch_audio import spectrogram_float64

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cases = [(f"percussive {s} s at {fps} fps", read_wavs_scale_for_video(
            [fabricate_percussive_wav(tmp / f"{s}.wav", seconds=s)], 512,
            frames_per_second=fps).wav_data) for s, fps in ((4.0, 30.0), (2.0, 30.0), (1.0, 10.0))]
        cases.append(("broadband noise, 60 vectors",
                      (np.random.RandomState(7).randn(60 * 512) * 0.3).astype(np.float32)))
        for label, audio in cases:
            exact = spectrogram_float64(audio, 512, (-1.0, 1.0))
            jax_out = np.asarray(jax_spectrogram.compute_spectrogram_smooth_scale(
                audio, 512, amplitude_range=(-1.0, 1.0)))
            port_out = spectrogram.compute_spectrogram_smooth_scale(
                audio, 512, amplitude_range=(-1.0, 1.0), device="cpu").numpy()
            print(f"{label}: max abs from the float64 derivation: JAX "
                  f"{np.abs(jax_out - exact).max():.3g}, port {np.abs(port_out - exact).max():.3g}")
            for roll in (False, True):
                blend = dict(alpha=0.25, fft_roll_enabled=roll, fft_amplitude_range=(-1.0, 1.0),
                             time_series_audio_vectors=audio, vector_length=512,
                             network_indices=[0, 1])
                got = alpha_blend_vectors_max_rms_power_audio(device="cpu", **blend)
                want = jax_blend(**blend)
                distance = max(_finite_max_abs(getattr(got, f).data, getattr(want, f).data)
                               for f in ("a_vectors", "combined"))
                print(f"{label}, roll {'on' if roll else 'off'}: noise-blend inputs, port "
                      f"against JAX, max abs {distance:.3g}")

        config = jax_g.GeneratorConfig(resolution=16, fmap_base=256, fmap_max=32, latent_size=512,
                                       dlatent_size=512, mapping_layers=2, mapping_fmaps=512)
        paths = []
        for i in range(2):
            paths.append(tmp / f"{i}_net.pkl")
            save_generator_pickle(jax_g.init_generator_params(jax.random.PRNGKey(i), config),
                                  paths[-1])
        audio = cases[2][1]
        blend = dict(alpha=0.25, fft_roll_enabled=False, fft_amplitude_range=(-1.0, 1.0),
                     time_series_audio_vectors=audio, vector_length=512, network_indices=[0, 1])
        port_inputs = alpha_blend_vectors_max_rms_power_audio(device="cpu", **blend)
        with MultiNetwork(paths, output_side_length=16) as networks:
            from_jax = np.stack(list(vector_synthesis(networks, jax_blend(**blend)).synthesized_images))
            jax_of_port = np.stack(list(vector_synthesis(networks, port_inputs).synthesized_images))
        with PortMultiNetwork(paths, output_side_length=16, device="cpu") as networks:
            from_port = np.stack(list(port_vector_synthesis(networks, port_inputs).synthesized_images))
        for what, frames in (("JAX's synthesis of the port's inputs", jax_of_port),
                             ("the port's synthesis of its own inputs", from_port)):
            steps = np.abs(from_jax.astype(int) - frames.astype(int))
            print(f"noise-blend frames of two 16px networks, {cases[2][0]}: JAX's synthesis of "
                  f"JAX's inputs against {what}: max {steps.max()} steps, "
                  f"{np.mean(steps <= 1):.6f} within 1 step")


def _finite_max_abs(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    return float(np.abs(got[finite] - want[finite]).max())


if __name__ == "__main__":
    main()
