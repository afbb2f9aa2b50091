"""Device resolution shared by every entry point of the port."""

from typing import Union

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
