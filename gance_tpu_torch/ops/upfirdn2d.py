"""
upfirdn2d — upsample, FIR filter, downsample — on NCHW tensors.

Semantics follow the public NVlabs definition, as in gance_tpu/ops/upfirdn2d.py:
  1. zero-stuff the input by `up` along H and W (each sample followed by up-1
     zeros),
  2. zero-pad by (pad0, pad1) on each spatial edge (negative pads crop),
  3. convolve (true convolution, kernel flipped) with a 2-D FIR per channel,
  4. keep every `down`-th sample.

`upfirdn2d` is the plain form for any FIR (the CPU path and the reference).
The synthesis path's two separable 4-tap cases go through hand-written
kernels, as JAX sends them to its polyphase and separable forms: the 2x
skip-chain upsample (`upsample_2d`, kernel B, with JAX's polyphase taps) and
the blur after the transpose conv of `upsample_conv_2d` (kernel C, a true
convolution like JAX's `upfirdn2d`). The discriminator's blur before a
strided conv (`conv_downsample_2d`) and `downsample_2d` run any 4x4 FIR with
pads in [0, 3] through kernel D, handed the FIR flipped (D correlates).

Which form a resample call takes, and its taps and pads, depend only on the
FIR, the gain, the factor and the conv's size. The analysis (normalising the
FIR, testing it for a separable 4-tap root) is numpy work of tens of
microseconds, so each resample function computes it once per key and keeps
it (`_plan`): a synthesis forward then runs no numpy on its resample calls.
"""

from typing import Callable, Dict, Hashable, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.cuda.fused_ops import (
    blur4_separable_pad11,
    stencil_blur4_valid,
    upsample2x_blur,
)

KernelLike = Union[Sequence[float], np.ndarray]

# The binomial resampling kernel used throughout StyleGAN2 (config-f default).
DEFAULT_RESAMPLE_KERNEL: Tuple[int, ...] = (1, 3, 3, 1)


def setup_filter_kernel(kernel: KernelLike, gain: float = 1.0) -> np.ndarray:
    """Normalize a 1-D or 2-D FIR to a 2-D float32 kernel with DC gain `gain`."""
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= np.sum(k)
    return k * gain


def _separable_root(k: np.ndarray) -> np.ndarray:
    """1-D factor r >= 0 of a separable 2-D kernel k = outer(r, r); r need not
    be symmetric (check with `_separable_4tap`)."""
    return np.sqrt(np.maximum(np.diag(k), 0.0))


def _separable_4tap(k: np.ndarray) -> bool:
    root = _separable_root(k)
    return k.shape == (4, 4) and np.allclose(np.outer(root, root), k)


_PLANS: Dict[Hashable, tuple] = {}


def _kernel_key(kernel: KernelLike) -> Hashable:
    """A hashable form of a FIR that equal FIRs share: the tuple itself (nested
    tuples of numbers included), else the values, shape and dtype of its
    numpy form (arrays, lists)."""
    if not isinstance(kernel, np.ndarray):
        try:
            key = tuple(kernel)
            hash(key)
            return key
        except TypeError:
            pass
    k = np.asarray(kernel)
    return (k.dtype.str, k.shape, k.tobytes())


def _plan(kind: str, kernel: KernelLike, args: tuple, make: Callable[..., tuple]) -> tuple:
    """make(kernel, *args), computed once per (kind, FIR, args) and kept.
    Arrays in a plan are read-only: every later call shares them."""
    key = (kind, _kernel_key(kernel), args)
    plan = _PLANS.get(key)
    if plan is None:
        plan = make(kernel, *args)
        for part in plan:
            if isinstance(part, np.ndarray):
                part.setflags(write=False)
        _PLANS[key] = plan
    return plan


def upfirdn2d(
    x: torch.Tensor,
    kernel: np.ndarray,
    up: int = 1,
    down: int = 1,
    pad0: int = 0,
    pad1: int = 0,
) -> torch.Tensor:
    """
    The upsample -> FIR -> downsample primitive on x (N, C, H, W), in plain
    PyTorch (a depthwise conv2d).

    :param kernel: 2-D FIR, already gain-scaled (see `setup_filter_kernel`).
    :return: (N, C, H_out, W_out), H_out = (H*up + pad0 + pad1 - kh) // down + 1.
    """
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d expects NCHW input, got shape {tuple(x.shape)}")
    kernel = np.asarray(kernel, dtype=np.float32)
    if kernel.ndim != 2:
        raise ValueError("upfirdn2d kernel must be 2D; use setup_filter_kernel first.")
    n, c, h, w = x.shape
    if up > 1:
        stuffed = x.new_zeros((n, c, h, up, w, up))
        stuffed[:, :, :, 0, :, 0] = x
        x = stuffed.reshape(n, c, h * up, w * up)
    x = F.pad(x, (pad0, pad1, pad0, pad1))  # negative pads crop
    # true convolution: conv2d correlates, so flip the kernel
    k = torch.from_numpy(np.ascontiguousarray(kernel[::-1, ::-1])).to(x.device, x.dtype)
    k = k[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x, k, stride=down, groups=c)


def upsample_2d(
    x: torch.Tensor,
    kernel: KernelLike = DEFAULT_RESAMPLE_KERNEL,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """FIR upsampling of NCHW x, NVlabs `upsample_2d` pad arithmetic. The 2x case
    with a separable 4-tap FIR runs kernel B in JAX's polyphase form
    (gance_tpu/ops/upfirdn2d.py::upsample_2d), whose even phase is
    k0*x[m-1] + k2*x[m] for the root k."""
    plan = _plan("up", kernel, (factor, gain), _upsample_plan)
    if plan[0] == "B":
        return upsample2x_blur(x, plan[1])
    _, k, pad0, pad1 = plan
    return upfirdn2d(x, k, up=factor, pad0=pad0, pad1=pad1)


def _upsample_plan(kernel: KernelLike, factor: int, gain: float) -> tuple:
    """("B", polyphase taps) or ("upfirdn2d", FIR, pad0, pad1) for `upsample_2d`."""
    k = setup_filter_kernel(kernel, gain * (factor**2))
    if factor == 2 and _separable_4tap(k):
        return "B", tuple(float(v) for v in _separable_root(k))
    p = k.shape[0] - factor
    return "upfirdn2d", k, (p + 1) // 2 + factor - 1, p // 2


def upsample_2d_nchw(
    xc: torch.Tensor,
    kernel: KernelLike = DEFAULT_RESAMPLE_KERNEL,
    gain: float = 1.0,
) -> torch.Tensor:
    """2x FIR upsampling of the synthesis RGB skip chain (the name the JAX
    synthesis path calls)."""
    return upsample_2d(xc, kernel, factor=2, gain=gain)


def upsample2x_phases_nchw(
    xc: torch.Tensor, taps: Sequence[float]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Kernel B's 2x upsample without the final interleave: the four phase planes
    ((i, j) = (row parity, column parity), each (B, C, H, W)) with
    `upsample2x_blur(xc, taps)[..., 2m+i, 2n+j] == phases[i*2+j][..., m, n]`
    bit for bit: the same fp32 terms in the same order, one rounding to xc's
    dtype at the end. Counterpart of gance_tpu/ops/upfirdn2d.py::
    upsample2x_phases_nchw, which JAX computes outside any Pallas kernel; it
    feeds `phase_top_block_uint8`.
    """
    k0, k1, k2, k3 = (float(t) for t in taps)
    xp = F.pad(xc.float(), (1, 1, 1, 1))
    left, mid, right = xp[..., :-2], xp[..., 1:-1], xp[..., 2:]
    h_even = k0 * left + k2 * mid
    h_odd = k1 * mid + k3 * right

    def vertical(hs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        up, vmid, down = hs[:, :, :-2], hs[:, :, 1:-1], hs[:, :, 2:]
        return (k0 * up + k2 * vmid).to(xc.dtype), (k1 * vmid + k3 * down).to(xc.dtype)

    v_even_j0, v_odd_j0 = vertical(h_even)
    v_even_j1, v_odd_j1 = vertical(h_odd)
    return v_even_j0, v_even_j1, v_odd_j0, v_odd_j1


def upsample_conv_2d(
    x: torch.Tensor,
    w: torch.Tensor,
    kernel: KernelLike = DEFAULT_RESAMPLE_KERNEL,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """
    Transpose conv (stride `factor`, VALID) followed by FIR smoothing: the
    `Conv0_up` layers of StyleGAN2 synthesis. x is (B, Cin, H, W), w is OIHW.

    The JAX reference correlates the zero-stuffed input with the *unflipped*
    weight (padded kh-1 on each side). `F.conv_transpose2d` flips its kernel
    and wants (Cin, Cout, kh, kw), so it gets w flipped and io-swapped; the
    two flips cancel. Output is (B, Cout, 2H+1, 2W+1) before the blur and
    (B, Cout, 2H, 2W) after it. The blur is upfirdn2d's true convolution, as in
    JAX; kernel C correlates, so a separable FIR reaches it with its root
    reversed.
    """
    plan = _plan("up_conv", kernel, (factor, gain, w.shape[2]), _upsample_conv_plan)
    y = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), stride=factor)
    if plan[0] == "C":
        return blur4_separable_pad11(y, plan[1])
    _, k, pad0, pad1 = plan
    return upfirdn2d(y, k, pad0=pad0, pad1=pad1)


def _upsample_conv_plan(kernel: KernelLike, factor: int, gain: float, ck: int) -> tuple:
    """("C", reversed root) or ("upfirdn2d", FIR, pad0, pad1) for the blur of
    `upsample_conv_2d` after a (ck x ck) transpose conv."""
    k = setup_filter_kernel(kernel, gain * (factor**2))
    p = (k.shape[0] - factor) - (ck - 1)
    pad0, pad1 = (p + 1) // 2 + factor - 1, p // 2 + 1
    if pad0 == 1 and pad1 == 1 and _separable_4tap(k):
        return "C", tuple(float(v) for v in _separable_root(k)[::-1])
    return "upfirdn2d", k, pad0, pad1


def _blur_plan(kernel: KernelLike, factor: int, gain: float, ck: int) -> tuple:
    """The blur before a stride-`factor` (ck x ck) conv, NVlabs pad arithmetic,
    as upfirdn2d(x, k, pad0, pad1) with up = down = 1: ("D", k flipped as 16
    row-major floats, pads) for a 4x4 FIR with pads in [0, 3] (D correlates
    and upfirdn2d convolves), else ("upfirdn2d", k, pads)."""
    k = setup_filter_kernel(kernel, gain)
    p = (k.shape[0] - factor) + (ck - 1)
    pads = ((p + 1) // 2, p // 2)
    if k.shape == (4, 4) and 0 <= pads[0] <= 3 and 0 <= pads[1] <= 3:
        return "D", tuple(float(v) for v in k[::-1, ::-1].reshape(-1)), pads
    return "upfirdn2d", k, pads


def _blur(x: torch.Tensor, plan: tuple) -> torch.Tensor:
    kind, k, (pad0, pad1) = plan
    if kind == "D":
        return stencil_blur4_valid(x, k, (pad0, pad1))
    return upfirdn2d(x, k, pad0=pad0, pad1=pad1)


def downsample_2d(
    x: torch.Tensor,
    kernel: KernelLike = DEFAULT_RESAMPLE_KERNEL,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """FIR downsampling of NCHW x, NVlabs `downsample_2d` pad arithmetic: the
    blur, then every `factor`-th sample."""
    plan = _plan("down", kernel, (factor, gain, 1), _blur_plan)
    return _blur(x, plan)[:, :, ::factor, ::factor]


def conv_downsample_2d(
    x: torch.Tensor,
    w: torch.Tensor,
    kernel: KernelLike = DEFAULT_RESAMPLE_KERNEL,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """
    FIR blur followed by a strided VALID convolution: the discriminator's
    `Conv1_down` (3x3, blur pad (2, 2)) and `Skip` (1x1, blur pad (1, 1))
    layers. x is (B, Cin, H, W), w is OIHW.
    """
    plan = _plan("down", kernel, (factor, gain, w.shape[2]), _blur_plan)
    return F.conv2d(_blur(x, plan), w, stride=factor)
