"""
"Synthesis files": JSON sidecars recording the vector fed into a network, the
network, and the resulting image, with md5 provenance (a copy of
gance_tpu/pipelines/synthesis_file.py, format-compatible with the reference,
including the v0/v1 field migration and the v0 shape fix, where vectors were
stored as (1, 512)).

Also here, as plain functions, the bodies of the still-image commands of
`cli/synthesize_images.py`:
  * `images_from_network_api`: per network, seeded random z filtered into
    face and face-free images by batched rejection sampling through the face
    detector, written as PNG + synthesis-file pairs;
  * `synthesis_file_into_networks_api`: the vectors of synthesis files
    replayed through every network.
PIL (the PNG writer) and cv2 (the face detector) are imported where used.
"""

import json
from dataclasses import asdict, dataclass
from enum import IntEnum
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from gance_tpu_torch.pipelines.noise_blend import _compute_dtype
from gance_tpu_torch.synthesis.runtime import DEFAULT_COMPUTE_DTYPE, SynthesisNetwork
from gance_tpu_torch.utils.device import Device
from gance_tpu_torch.utils.hashing import hash_file
from gance_tpu_torch.utils.logging import LOGGER

SYNTHESIS_FILE_SUFFIX = ".json"
DEFAULT_RANDOM_SEED = 1234
FILTER_BATCH = 8  # vectors per rejection-sampling round, as gance_tpu draws them
MAX_ATTEMPTS_PER_IMAGE = 100


class Version(IntEnum):
    """Synthesis file versions (v2 renamed model_* fields to network_*)."""

    version_0 = 0
    version_1 = 1
    version_2 = 2


@dataclass
class SynthesisFileDict:
    """Properties of one synthesis run (field-compatible with the reference)."""

    vector: Union[List[List[float]], List[float]]
    network_path: str
    network_hash: str
    image_path: str
    image_hash: str
    version: Optional[int] = None


def write_synthesis_file(
    destination_path: Path,
    vector: np.ndarray,
    network_path: Path,
    network_hash: str,
    image_path: Path,
    image_hash: str,
) -> None:
    """Write a v2 synthesis file."""
    with open(str(destination_path), "w") as file:
        json.dump(
            asdict(
                SynthesisFileDict(
                    network_path=str(network_path),
                    network_hash=network_hash,
                    image_path=str(image_path),
                    image_hash=image_hash,
                    vector=np.asarray(vector).tolist(),
                    version=int(Version.version_2),
                )
            ),
            file,
        )


def read_synthesis_file(path_to_json: Path) -> SynthesisFileDict:
    """Read and migrate a synthesis file of any version."""
    with open(str(path_to_json), "r") as file:
        raw = json.load(file)
    if "version" not in raw or (raw["version"] or 0) < Version.version_2:
        raw["network_path"] = raw.pop("model_path")
        raw["network_hash"] = raw.pop("model_hash")
    return SynthesisFileDict(**{k: raw.get(k) for k in SynthesisFileDict.__annotations__})


def read_vector_in_file(path_to_json: Path) -> np.ndarray:
    """The input vector only, with the v0 shape bug fixed (v0 stored the
    (1, 512) network-input form)."""
    loaded = read_synthesis_file(path_to_json)
    version = loaded.version if loaded.version is not None else Version.version_0
    vector = np.array(loaded.vector)
    if version == Version.version_0:
        vector = vector[0]
    return vector


def _load(path: Path, compute_dtype: Optional[str], device: Device) -> SynthesisNetwork:
    return SynthesisNetwork.from_pkl(
        Path(path), device=device,
        compute_dtype=_compute_dtype(compute_dtype) or DEFAULT_COMPUTE_DTYPE)


def filtered_images(
    network,
    wanted_faces: bool,
    count: int,
    rng: np.random.RandomState,
    has_face: Callable[[np.ndarray], bool],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """
    Rejection-sample (vector, image) pairs until `count` images with (or
    without) a face are found, FILTER_BATCH z per round; gives up after
    MAX_ATTEMPTS_PER_IMAGE * count vectors.
    """
    results: List[Tuple[np.ndarray, np.ndarray]] = []
    attempts = 0
    while len(results) < count and attempts < MAX_ATTEMPTS_PER_IMAGE * count:
        vectors = rng.standard_normal((FILTER_BATCH, network.expected_vector_length)).astype(
            np.float32
        )
        for vector, image in zip(vectors, network.images_from_vectors(vectors)):
            if has_face(image) == wanted_faces:
                results.append((vector, image))
                if len(results) >= count:
                    break
        attempts += FILTER_BATCH
    if len(results) < count:
        LOGGER.warning("Only found %d/%d images with faces=%s", len(results), count, wanted_faces)
    return results


def images_from_network_api(
    networks_directory: Path,
    output_directory: Path,
    num_faces: int = 1,
    no_faces: int = 1,
    random_seed: int = DEFAULT_RANDOM_SEED,
    compute_dtype: Optional[str] = None,
    device: Device = "cuda",
) -> List[Path]:
    """
    Per network of `networks_directory` (sorted), `num_faces` images with a
    face and `no_faces` without, from z drawn by `np.random.RandomState(
    random_seed)` (re-seeded per network, as gance_tpu does, so both packages
    draw the same z). Each image is written as `{stem}_{md5}_{label}_{index}.png`
    beside its synthesis file (`.json`). Returns the synthesis files.
    """
    from gance_tpu_torch.media.images import write_image
    from gance_tpu_torch.models.pickle_loader import sorted_networks_in_directory
    from gance_tpu_torch.overlay.faces import FaceFinderProxy

    out_dir = Path(output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    finder = FaceFinderProxy()

    def has_face(image: np.ndarray) -> bool:
        return len(finder.face_locations(image)) > 0

    written: List[Path] = []
    for network_path in sorted_networks_in_directory(Path(networks_directory)):
        LOGGER.info("Synthesizing images from %s", network_path)
        network = _load(network_path, compute_dtype, device)
        network_hash = hash_file(network_path)
        rng = np.random.RandomState(random_seed)
        for label, wanted, count in (("face", True, num_faces), ("no_face", False, no_faces)):
            for index, (vector, image) in enumerate(
                filtered_images(network, wanted, count, rng, has_face)
            ):
                stem = f"{network_path.stem}_{network_hash}_{label}_{index}"
                image_path = out_dir / f"{stem}.png"
                write_image(image, image_path)
                write_synthesis_file(
                    destination_path=out_dir / f"{stem}{SYNTHESIS_FILE_SUFFIX}",
                    vector=vector,
                    network_path=network_path,
                    network_hash=network_hash,
                    image_path=image_path,
                    image_hash=hash_file(image_path),
                )
                written.append(out_dir / f"{stem}{SYNTHESIS_FILE_SUFFIX}")
    return written


def synthesis_file_into_networks_api(
    synthesis_paths: Sequence[Path],
    network_paths: Sequence[Path],
    output_directory: Path,
    compute_dtype: Optional[str] = None,
    device: Device = "cuda",
) -> List[Path]:
    """
    Replay the vectors of `synthesis_paths` through every network of
    `network_paths` (networks outer, as the reference orders it), writing
    `{network stem}_{synthesis file stem}.png`. Returns the images written.

    The vectors go through in batches of FILTER_BATCH, where gance_tpu
    stacks every vector into one batch: the same images up to the summation
    order, with memory that does not grow with the number of files.
    """
    from gance_tpu_torch.media.images import write_image

    if not synthesis_paths:
        raise ValueError("No synthesis files given.")
    out_dir = Path(output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [Path(p) for p in synthesis_paths]
    vectors = np.stack([read_vector_in_file(p) for p in sources])
    written: List[Path] = []
    for network_path in network_paths:
        network = _load(network_path, compute_dtype, device)
        for begin in range(0, len(sources), FILTER_BATCH):
            images = network.images_from_vectors(vectors[begin:begin + FILTER_BATCH])
            for source, image in zip(sources[begin:begin + FILTER_BATCH], images):
                target = out_dir / f"{Path(network_path).stem}_{source.stem}.png"
                write_image(image, target)
                written.append(target)
        LOGGER.info("Replayed %d vectors through %s", len(sources), network_path)
    return written
