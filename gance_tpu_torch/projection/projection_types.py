"""
Projection data types + the projection-file attribute block (the port's copy
of gance_tpu/projection/projection_types.py, which holds no JAX).

`ProjectionAttributes` is serialized as HDF5 root attrs with h5py-compatible
coercions (tuples -> arrays, None-able video fields -> nan, the np.nan
`noises_shapes` quirk of the reference format), and `from_attrs_dict` migrates
version-1 attribute names to version 2.
"""

from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

# Shape aliases (reference projection_types.py:10-19)
CompleteLatentsType = np.ndarray  # (1, num_style_rows, 512)
NoisesType = np.ndarray  # one noise buffer, varying shape
FlattenedNoisesType = np.ndarray  # all noise buffers flattened + concatenated
NoisesShapesType = List[Tuple[int, ...]]

LATEST_VERSION = 2

# HDF5 group names (schema v2; single source of truth for writer + reader)
TARGET_IMAGES_GROUP_NAME = "target_images"
FINAL_LATENTS_GROUP_NAME = "final_latents"
FINAL_IMAGE_GROUP_NAME = "final_images"
LATENTS_HISTORIES_GROUP_NAME = "latents_histories"
IMAGES_HISTORIES_GROUP_NAME = "images_histories"
NOISES_HISTORIES_GROUP_NAME = "noises_histories"


def complete_latents_to_matrix(complete_latents: CompleteLatentsType) -> np.ndarray:
    """(1, R, V) -> (R, V) (reference projection_types.py:22-28)."""
    return np.asarray(complete_latents)[0]


@dataclass
class ProjectionAttributes:
    """Metadata block stored as HDF5 root attrs (field-compatible with v2)."""

    version_number: int
    complete: bool
    original_target_path: str
    original_width_height: Tuple[int, int]
    projection_width_height: Tuple[int, int]
    target_md5_hash: str
    original_network_path: str
    network_md5_hash: str
    steps_in_projection: int
    # list of noise-buffer shapes, or np.nan when never discovered (the reference's
    # "THIS SAYS np.float BUT THE ONLY ACCEPTABLE VALUE HERE IS np.nan" quirk)
    noises_shapes: Union[NoisesShapesType, float]
    latents_histories_enabled: bool
    noises_histories_enabled: bool
    images_histories_enabled: bool
    original_fps: Optional[float]
    projection_fps: Optional[float]
    original_frame_count: Optional[int]
    projection_frame_count: Optional[int]

    def to_attrs_dict(self) -> Dict[str, Any]:
        """h5py-storable dict: tuples->arrays, None->np.nan, shapes->(L,rank) array."""
        out: Dict[str, Any] = {}
        for key, value in asdict(self).items():
            if key == "noises_shapes":
                if isinstance(value, (list, tuple)) and len(value):
                    out[key] = np.asarray(value, dtype=np.int64)
                else:
                    out[key] = np.nan
            elif value is None:
                out[key] = np.nan
            elif isinstance(value, tuple):
                out[key] = np.asarray(value)
            else:
                out[key] = value
        return out

    @classmethod
    def from_attrs_dict(cls, attrs: Dict[str, Any]) -> "ProjectionAttributes":
        """Parse h5py attrs, including the v1 -> v2 field migration
        (reference projection_file_reader.py:114-119: model_* -> network_*)."""
        attrs = dict(attrs)
        if int(attrs["version_number"]) == 1:
            attrs["original_network_path"] = attrs.pop("original_model_path")
            attrs["network_md5_hash"] = attrs.pop("model_md5_hash")
            attrs["version_number"] = LATEST_VERSION

        def opt_float(v: Any) -> Optional[float]:
            v = _scalar(v)
            return None if v is None or (isinstance(v, float) and np.isnan(v)) else float(v)

        def opt_int(v: Any) -> Optional[int]:
            f = opt_float(v)
            return None if f is None else int(f)

        noises_shapes: Union[NoisesShapesType, float]
        raw_shapes = attrs["noises_shapes"]
        if np.ndim(raw_shapes) >= 2:
            noises_shapes = [tuple(int(x) for x in row) for row in np.asarray(raw_shapes)]
        else:
            noises_shapes = np.nan

        return cls(
            version_number=int(_scalar(attrs["version_number"])),
            complete=bool(_scalar(attrs["complete"])),
            original_target_path=_text(attrs["original_target_path"]),
            original_width_height=tuple(
                int(x) for x in np.asarray(attrs["original_width_height"])
            ),
            projection_width_height=tuple(
                int(x) for x in np.asarray(attrs["projection_width_height"])
            ),
            target_md5_hash=_text(attrs["target_md5_hash"]),
            original_network_path=_text(attrs["original_network_path"]),
            network_md5_hash=_text(attrs["network_md5_hash"]),
            steps_in_projection=int(_scalar(attrs["steps_in_projection"])),
            noises_shapes=noises_shapes,
            latents_histories_enabled=bool(_scalar(attrs["latents_histories_enabled"])),
            noises_histories_enabled=bool(_scalar(attrs["noises_histories_enabled"])),
            images_histories_enabled=bool(_scalar(attrs["images_histories_enabled"])),
            original_fps=opt_float(attrs.get("original_fps")),
            projection_fps=opt_float(attrs.get("projection_fps")),
            original_frame_count=opt_int(attrs.get("original_frame_count")),
            projection_frame_count=opt_int(attrs.get("projection_frame_count")),
        )


def _scalar(value: Any) -> Any:
    if isinstance(value, np.ndarray) and value.ndim == 0:
        return value.item()
    if isinstance(value, np.generic):
        return value.item()
    return value


def _text(value: Any) -> str:
    value = _scalar(value)
    if isinstance(value, bytes):
        return value.decode()
    return str(value)
