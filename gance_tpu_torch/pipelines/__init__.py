"""
The port's pipelines: audio -> video assemblies wiring the audio DSP, the
synthesis runtime and media egress together (noise_blend today; the
projection-file blend is ROADMAP.md Queue 1 item 6).
"""

from gance_tpu_torch.pipelines.noise_blend import noise_blend_api

__all__ = ["noise_blend_api"]
