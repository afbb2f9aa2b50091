"""
Bias + activation (+gain, +clamp) in plain PyTorch.

Used by the mapping network and by synthesis layers that add no noise; the
noise-carrying synthesis epilogue goes through the fused CUDA kernel
(`ops/cuda/fused_ops.fused_bias_noise_lrelu`).
"""

import math
from typing import Optional

import torch

LRELU_ALPHA = 0.2
LRELU_GAIN = math.sqrt(2.0)

_ACT_DEFAULT_GAIN = {
    "linear": 1.0,
    "lrelu": LRELU_GAIN,
    "relu": LRELU_GAIN,
    "tanh": 1.0,
    "sigmoid": 1.0,
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    act: str = "linear",
    alpha: float = LRELU_ALPHA,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
    axis: int = 1,
) -> torch.Tensor:
    """
    Compute `act(x + b) * gain`, optionally clamped to [-clamp, clamp].

    :param b: bias broadcast along `axis` (the channel axis: 1 for NCHW and for
        (B, C) rows).
    :param act: one of 'linear', 'lrelu', 'relu', 'tanh', 'sigmoid'.
    :param gain: post-activation gain; defaults to the activation's canonical
        gain (sqrt(2) for lrelu).
    """
    if act not in _ACT_DEFAULT_GAIN:
        raise ValueError(f"Unknown activation {act!r}")
    if gain is None:
        gain = _ACT_DEFAULT_GAIN[act]
    if b is not None:
        shape = [1] * x.ndim
        shape[axis] = b.shape[0]
        x = x + b.reshape(shape).to(x.dtype)
    if act == "lrelu":
        x = torch.maximum(x, x * alpha)
    elif act == "relu":
        x = torch.relu(x)
    elif act == "tanh":
        x = torch.tanh(x)
    elif act == "sigmoid":
        x = torch.sigmoid(x)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
