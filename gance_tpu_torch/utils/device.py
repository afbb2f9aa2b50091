"""Device resolution and params placement shared by every entry point of the port."""

from typing import Any, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """The torch device to run on; a CUDA device on a host without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def params_to_device(params: Any, device: torch.device) -> Any:
    """A params tree of numpy arrays (or tensors) -> float32 tensors on `device`,
    copied, so the tree never aliases the caller's arrays."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    if torch.is_tensor(params):
        return params.to(device=device, dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(params, dtype=np.float32)).to(device)
