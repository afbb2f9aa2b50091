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

from typing import Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.cuda.autograd import blur4_separable_pad11_input_grad
from gance_tpu_torch.ops.cuda.fused_ops import (
    blur4_separable_pad11,
    blur4_separable_pad11_phases,
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

    :param kernel: 2-D FIR, already gain-scaled (see `setup_filter_kernel`);
        or a 1-D FIR k, the separable outer(k, k), applied along W and then
        along H as NVlabs' upfirdn2d applies a 1-D filter (k carries the gain
        of one axis).
    :return: (N, C, H_out, W_out), H_out = (H*up + pad0 + pad1 - kh) // down + 1.
    """
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d expects NCHW input, got shape {tuple(x.shape)}")
    kernel = np.asarray(kernel, dtype=np.float32)
    if kernel.ndim not in (1, 2):
        raise ValueError("upfirdn2d kernel must be 1-D (separable) or 2-D.")
    n, c, h, w = x.shape
    if up > 1:
        stuffed = x.new_zeros((n, c, h, up, w, up))
        stuffed[:, :, :, 0, :, 0] = x
        x = stuffed.reshape(n, c, h * up, w * up)
    x = F.pad(x, (pad0, pad1, pad0, pad1))  # negative pads crop
    # true convolution: conv2d correlates, so flip the kernel
    if kernel.ndim == 1:
        k = torch.from_numpy(kernel[::-1].copy()).to(x.device, x.dtype)
        k = k[None, None].expand(c, 1, kernel.shape[0])
        x = F.conv2d(x, k[:, :, None, :], stride=(1, down), groups=c)
        return F.conv2d(x, k[:, :, :, None], stride=(down, 1), groups=c)
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


def _axis_phases(ck: int, factor: int) -> List[Optional[Tuple[int, int]]]:
    """
    One axis of a stride-`factor` transposed conv with a `ck`-tap kernel, split
    by output phase. Output sample r = factor*q + i of the transposed conv sums
    x[m] * w[a] over the taps a with (r + a - (ck - 1)) % factor == 0,
    m = (r + a - (ck - 1)) / factor (JAX's correlation of the zero-stuffed
    input with the unflipped weight padded ck - 1). So phase i is a stride-1
    correlation of x, padded by the same count on both sides, with the taps
    first::factor, first = (ck - 1 - i) % factor; its output has as many
    samples as phase i of the transposed conv's. Returns per phase i (first,
    pad), or None where no tap reaches the phase (its samples are 0).
    """
    phases: List[Optional[Tuple[int, int]]] = []
    for i in range(factor):
        first = (ck - 1 - i) % factor
        phases.append(None if first >= ck else (first, (ck - 1 - i - first) // factor))
    return phases


def phase_convs(
    x: torch.Tensor, w: torch.Tensor, factor: int
) -> Iterator[Tuple[int, int, Optional[torch.Tensor]]]:
    """
    The output phases (i, j) of the stride-`factor` VALID transposed conv of
    `upsample_conv_2d`, row-major: a stride-1 forward conv of x each
    (`_axis_phases`), or None where no tap reaches the phase (its samples are
    0). Phase (i, j) holds the transposed conv's samples [i::factor,
    j::factor]. The phases do the transposed conv's own kh*kw taps per input
    sample, and cuDNN's forward algorithms add without atomics, so they repeat
    themselves bit for bit: `F.conv_transpose2d`'s forward is cuDNN's
    backward-data pass, whose default fp32 algorithms gave 1024px frames up
    to 1 uint8 step apart from one call to the next on an H100. For factor 2
    and a 3x3 weight the phases are 2x2, 2x1, 1x2 and 1x1 convs.
    """
    kh, kw = w.shape[2:]
    for i, row in enumerate(_axis_phases(kh, factor)):
        for j, col in enumerate(_axis_phases(kw, factor)):
            if row is None or col is None:
                yield i, j, None
            else:
                taps = w[:, :, row[0]::factor, col[0]::factor]
                yield i, j, F.conv2d(x, taps, padding=(row[1], col[1]))


def transposed_conv_phases(x: torch.Tensor, w: torch.Tensor, factor: int) -> torch.Tensor:
    """
    The stride-`factor` VALID transposed conv of `upsample_conv_2d` before its
    blur, (B, Cin, H, W) -> (B, Cout, factor*(H-1)+kh, factor*(W-1)+kw), w OIHW
    unflipped as JAX holds it: its phases (`phase_convs`) written into strided
    slices of one tensor, for the blurs that take the interleaved tensor.
    """
    b, _, h, wd = x.shape
    cout, _, kh, kw = w.shape
    y = x.new_empty((b, cout, factor * (h - 1) + kh, factor * (wd - 1) + kw))
    for i, j, p in phase_convs(x, w, factor):
        if p is None:
            y[:, :, i::factor, j::factor].zero_()
        else:
            y[:, :, i::factor, j::factor] = p
    return y


def _transposed_conv_grads(
    ctx, gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, f: int
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """x's and w's gradients of the transposed conv given gy, its output's:
    one `convolution_backward` of `F.conv_transpose2d`, whose input gradient
    is a stride-`f` forward conv."""
    gx, gwt, _ = torch.ops.aten.convolution_backward(
        gy, x, w.flip(2, 3).transpose(0, 1), None, [f, f], [0, 0], [1, 1], True, [0, 0],
        1, (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
    return gx, None if gwt is None else gwt.transpose(0, 1).flip(2, 3)


class _PhasedTransposedConv(torch.autograd.Function):
    """
    The transposed conv, forward as its phases (`transposed_conv_phases`) and
    backward as `F.conv_transpose2d`'s own (`_transposed_conv_grads`).
    Through the phases' own autograd backward (four backward-data passes and
    four weight gradients) config-f's eight Conv0_up took 134.757 ms forward
    and backward per 1024px synthesis at batch 4 in fp32, against 67.572 for
    the transposed conv and 70.597 this way (NVIDIA H100 80GB HBM3, 700.00 W;
    tools/time_torch_upconv_phases.py). The backward is itself made of
    differentiable ops, so second order (path length) runs through it.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, factor: int) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.factor = factor
        return transposed_conv_phases(x, w, factor)

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        x, w = ctx.saved_tensors
        return (*_transposed_conv_grads(ctx, gy, x, w, ctx.factor), None)


class _PhasedUpconvBlur(torch.autograd.Function):
    """
    A stride-2 3x3 transposed conv and kernel C's blur after it: the four
    phases (`phase_convs`) go to C as they are (`blur4_separable_pad11_phases`),
    which reads them where an interleave into the pre-blur tensor would read
    and write them once more. Backward: C's input gradient (kernel D), then
    the transposed conv's (`_transposed_conv_grads`); both are differentiable.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, taps: Tuple[float, ...]) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.taps = taps
        return blur4_separable_pad11_phases([p for _, _, p in phase_convs(x, w, 2)], taps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gy = blur4_separable_pad11_input_grad(g, ctx.taps)
        return (*_transposed_conv_grads(ctx, gy, x, w, 2), None)


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
    weight (padded kh-1 on each side). In fp32 the port computes the same
    sums, in another order, as one stride-1 conv per output phase
    (`phase_convs`), so the result repeats itself bit for bit; where the blur
    is kernel C, C reads the phases themselves (`_PhasedUpconvBlur`).
    Output is (B, Cout, 2H+1, 2W+1) before the blur and (B, Cout, 2H, 2W)
    after it. The blur is upfirdn2d's true convolution, as in JAX; kernel C
    correlates, so a separable FIR reaches it with its root reversed.
    """
    plan = _plan("up_conv", kernel, (factor, gain, w.shape[2]), _upsample_conv_plan)
    if x.dtype == torch.bfloat16:
        # bf16 keeps the transposed conv, which repeats itself in bf16: config-f's
        # eight Conv0_up at batch 8 took 6.256 ms per 1024px forward as it and
        # 12.833 as phases, and synthesis 38.6-41.1 ms per batch against
        # 45.2-49.3 (NVIDIA H100 80GB HBM3, 700.00 W;
        # tools/time_torch_upconv_phases.py, tools/time_torch_deterministic_cudnn.py).
        # conv_transpose2d flips its kernel and wants (Cin, Cout, kh, kw): it gets
        # w flipped and io-swapped, and the two flips cancel.
        y = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), stride=factor)
    elif plan[0] == "C":
        return _PhasedUpconvBlur.apply(x, w, plan[1])
    else:
        y = _PhasedTransposedConv.apply(x, w, factor)
    if plan[0] == "C":
        return blur4_separable_pad11(y, plan[1])
    _, k, pad0, pad1 = plan
    return upfirdn2d(y, k, pad0=pad0, pad1=pad1)


def _upsample_conv_plan(kernel: KernelLike, factor: int, gain: float, ck: int) -> tuple:
    """("C", reversed root) or ("upfirdn2d", FIR, pad0, pad1) for the blur of
    `upsample_conv_2d` after a (ck x ck) transpose conv. C takes factor 2 only
    (with pads (1, 1), a 3x3 conv), whose four phases it reads in fp32."""
    k = setup_filter_kernel(kernel, gain * (factor**2))
    p = (k.shape[0] - factor) - (ck - 1)
    pad0, pad1 = (p + 1) // 2 + factor - 1, p // 2 + 1
    if factor == 2 and pad0 == 1 and pad1 == 1 and _separable_4tap(k):
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
    return F.conv2d(conv_downsample_blur(x, w.shape[2], kernel, factor, gain), w, stride=factor)


def conv_downsample_blur(
    x: torch.Tensor,
    conv_size: int,
    kernel: KernelLike = DEFAULT_RESAMPLE_KERNEL,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """The blur of `conv_downsample_2d` before its (conv_size x conv_size)
    strided conv, alone: a tensor-parallel layer blurs its whole input once
    and each model slot convolves it with its block of output channels."""
    return _blur(x, _plan("down", kernel, (factor, gain, conv_size), _blur_plan))
