"""
Validate network pickles and copy the good ones into a production directory
(the body of `cli/check_move_networks.py`; the counterpart of
gance_tpu/cli/check_move_networks.py): each sorted .pkl of the given
directories is loaded and renders one gaussian vector (a bit-rot check); a
valid one is copied as `{count}_{parent}_{name}`, skipping
`submit_config.pkl` and anything whose md5 was already copied.

Departure from gance_tpu, which catches every exception around the load and
the forward: only what a bad pickle raises rejects a network (an unreadable
or truncated pickle, missing or mis-shaped parameters, an all-zero image).
The forward runs outside the catch, so a kernel that fails to build or
launch stops the check instead of rejecting the network, and on CUDA the
kernels are built before the first network is read.
"""

import pickle
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from gance_tpu_torch.utils.device import Device, resolve_device
from gance_tpu_torch.utils.hashing import hash_file
from gance_tpu_torch.utils.logging import LOGGER

# What reading a bad pickle raises: all host-side, from the unpickler, the
# parameter tree's conversion and the shape check below.
BAD_PICKLE_ERRORS = (
    pickle.UnpicklingError, EOFError, ValueError, KeyError, IndexError, TypeError,
    AttributeError,
)


def _leaf_shapes(tree: Dict[str, Any], prefix: str = "") -> Dict[str, tuple]:
    shapes: Dict[str, tuple] = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            shapes.update(_leaf_shapes(value, name))
        else:
            shapes[name] = tuple(np.shape(value))
    return shapes


def check_parameter_shapes(params: Dict[str, Any], config) -> None:
    """Raise ValueError when a parameter of `config`'s generator is missing
    from `params` or has another shape."""
    from gance_tpu_torch.models.stylegan2 import init_generator_params

    have = _leaf_shapes(params)
    wrong = [
        f"{name}: {have.get(name, 'missing')} != {shape}"
        for name, shape in _leaf_shapes(init_generator_params(0, config)).items()
        if have.get(name) != shape
    ]
    if wrong:
        raise ValueError(f"parameters do not match {config}: {wrong[:8]}")


def validate_network(path: Path, device: Device) -> Optional[str]:
    """None when the network at `path` loads and renders a non-zero image from
    one gaussian vector; else why it is rejected. Errors of the render itself
    propagate."""
    from gance_tpu_torch.models.pickle_loader import load_generator
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    try:
        params, config = load_generator(Path(path))
        check_parameter_shapes(params, config)
    except BAD_PICKLE_ERRORS as e:
        return f"{type(e).__name__}: {e}"
    network = SynthesisNetwork.from_staged((params, config), Path(path), device=device)
    vector = np.random.RandomState(0).standard_normal(
        (1, network.expected_vector_length)
    ).astype(np.float32)
    if network.images_from_vectors(vector).sum() == 0:
        return "Network produced an all-zero image"
    return None


def check_move_networks_api(
    networks_directories: Sequence[Path], output_directory: Path, device: Device = "cuda"
) -> List[Path]:
    """Validate and copy networks (module docstring); returns the copies."""
    from gance_tpu_torch.models.pickle_loader import sorted_networks_in_directory

    device = resolve_device(device)
    if device.type == "cuda":
        from gance_tpu_torch.ops.cuda import build

        build.build_all()
    out_dir = Path(output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    already_copied = {hash_file(p) for p in out_dir.glob("*.pkl")}

    copied: List[Path] = []
    for directory in networks_directories:
        for pkl in sorted_networks_in_directory(Path(directory)):
            if pkl.name == "submit_config.pkl":
                continue
            digest = hash_file(pkl)
            if digest in already_copied:
                LOGGER.info("Skipping already-copied %s", pkl)
                continue
            reason = validate_network(pkl, device)
            if reason is not None:
                LOGGER.warning("Rejecting %s: %s", pkl, reason)
                continue
            destination = out_dir / f"{len(copied)}_{pkl.parent.name}_{pkl.name}"
            shutil.copy2(pkl, destination)
            already_copied.add(digest)
            LOGGER.info("Copied %s -> %s", pkl, destination)
            copied.append(destination)
    LOGGER.info("Copied %d networks", len(copied))
    return copied
