"""
The port's pipelines: audio -> video assemblies wiring the audio DSP, the
synthesis runtime and media egress together: noise_blend, and the flagship
projection_file_blend with its eye-tracked overlay.
"""

from gance_tpu_torch.pipelines.noise_blend import noise_blend_api
from gance_tpu_torch.pipelines.projection_file_blend import projection_file_blend_api

__all__ = ["noise_blend_api", "projection_file_blend_api"]
