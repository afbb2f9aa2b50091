"""
Compute-precision policy for the synthesis convs and dense layers.

One knob, read once at import, the same as gance_tpu's: GANCE_TPU_PRECISION =
  * "highest" (default) — exact fp32. cuDNN convolutions use TF32 by default on
    Ampere and later, which keeps about three decimal digits and breaks parity
    with the reference, so this tier turns TF32 off for convs and matmuls.
  * "high" / "default" — TF32 allowed for fp32 convs and matmuls.

The style/demod dots in modulated conv, `resize_images` and the plain twins
of the kernels that sum products always run in exact fp32 (`exact_fp32`),
whatever the tier. fp32 synthesis repeats itself bit for bit under cuDNN's
default algorithms: each `Conv0_up` runs as stride-1 phase convolutions
(`ops/upfirdn2d.py`), and cuDNN's forward algorithms add without atomics.
Resumable renders, the metrics and the card checks of training and
projection still run under `deterministic_cudnn`, which costs a synthesis
forward nothing and keeps cuDNN off algorithms that add with atomics
wherever else it would pick one (weight gradients in a backward pass).
"""

import os
from contextlib import contextmanager
from typing import Iterator

import torch

_NAMES = ("highest", "high", "default")

CONV_PRECISION = os.environ.get("GANCE_TPU_PRECISION", "highest").lower()
if CONV_PRECISION not in _NAMES:
    raise ValueError(f"GANCE_TPU_PRECISION={CONV_PRECISION!r}: expected one of {_NAMES}")


def apply_conv_precision() -> None:
    """Set the TF32 flags for this tier (called where the fp32 path runs)."""
    allow = CONV_PRECISION != "highest"
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow


@contextmanager
def exact_fp32() -> Iterator[None]:
    """Run the enclosed convolutions and matmuls in full fp32 (no TF32), then
    restore both flags."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """Run the enclosed cuDNN calls with deterministic algorithms only, then
    restore the flag. A synthesis forward repeats itself without it (its
    convolutions are forward passes; each `Conv0_up` runs as phase
    convolutions, ops/upfirdn2d.py) and costs the same under it: fp32 1024px
    at batch 8, 130.378-131.051 ms per batch under it against
    130.165-134.770 without (NVIDIA H100 80GB HBM3, 700.00 W;
    tools/time_torch_deterministic_cudnn.py). Resumable renders, whose
    resumed frames must equal an unbroken render's, the metrics and the card
    checks of training and projection keep it: in a backward pass cuDNN's
    default weight-gradient algorithms may add with atomics."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
