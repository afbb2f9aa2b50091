"""
The port's projection layer: the projector (`Projector`, the counterpart of
gance_tpu's `TPUProjector`, optimising w and the noise planes against
LPIPS/VGG16 on the device), the perceptual metric and its weight import, the
HDF5 "projection file" format v2 (attributes, streaming reader and verifier,
writer, h5py imported where it is used) and `project_video_to_file`.
`visualization.py` waits for ROADMAP.md Queue 1 item 13 (viz).
"""

from gance_tpu_torch.projection.file_reader import (
    ProjectionFileReader,
    final_latents_matrices_label,
    load_projection_file,
    verify_projection_file_assumptions,
)
from gance_tpu_torch.projection.file_writer import (
    NullProjectionFileWriter,
    ProjectionFileWriter,
    flatten_noises,
    project_video_to_file,
)
from gance_tpu_torch.projection.lpips import (
    downsample_to,
    load_vgg_params,
    lpips_distance,
    random_vgg_params,
    vgg_features,
    vgg_params_to_device,
)
from gance_tpu_torch.projection.projection_types import (
    LATEST_VERSION,
    ProjectionAttributes,
    complete_latents_to_matrix,
)
from gance_tpu_torch.projection.projector import (
    ProjectionResult,
    Projector,
    ProjectorSettings,
    convergence_should_stop,
)

__all__ = [
    "LATEST_VERSION",
    "ProjectionAttributes",
    "complete_latents_to_matrix",
    "ProjectionFileReader",
    "load_projection_file",
    "final_latents_matrices_label",
    "verify_projection_file_assumptions",
    "ProjectionFileWriter",
    "NullProjectionFileWriter",
    "flatten_noises",
    "project_video_to_file",
    "Projector",
    "ProjectorSettings",
    "ProjectionResult",
    "convergence_should_stop",
    "random_vgg_params",
    "load_vgg_params",
    "vgg_params_to_device",
    "vgg_features",
    "lpips_distance",
    "downsample_to",
]
