"""
The port's projection-file layer: the HDF5 "projection file" format v2
(attributes, streaming reader and verifier, writer), host-only, with h5py
imported where it is used. The projector itself is ROADMAP.md Queue 1 item 7.
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
)
from gance_tpu_torch.projection.projection_types import (
    LATEST_VERSION,
    ProjectionAttributes,
    complete_latents_to_matrix,
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
]
