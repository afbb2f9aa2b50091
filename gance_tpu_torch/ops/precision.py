"""
Compute-precision policy for the synthesis convs and dense layers.

One knob, read once at import, the same as gance_tpu's: GANCE_TPU_PRECISION =
  * "highest" (default) — exact fp32. cuDNN convolutions use TF32 by default on
    Ampere and later, which keeps about three decimal digits and breaks parity
    with the reference, so this tier turns TF32 off for convs and matmuls.
  * "high" / "default" — TF32 allowed for fp32 convs and matmuls.

The style/demod dots in modulated conv, `resize_images` and the plain twins
of the kernels that sum products always run in exact fp32 (`exact_fp32`),
whatever the tier. A resumable render runs with cuDNN's deterministic
algorithms (`deterministic_cudnn`), so that it gives the same frames on every
run.
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
    restore the flag. A transposed convolution's forward is cuDNN's
    backward-data pass, whose default fp32 algorithms on an H100 gave one batch
    of 1024px frames up to 1 uint8 step apart from one call to the next (bf16
    repeated itself). A resumable render needs frames that repeat, or a resumed
    render cannot equal an unbroken one; the deterministic algorithms cost
    fp32 synthesis about half again as much time (PERF.md), so only
    resumable renders ask for them."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
