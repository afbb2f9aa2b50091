"""
StyleGAN3's filtered leaky ReLU (NVlabs/stylegan3 `torch_utils/ops/
filtered_lrelu.py`) on NCHW fp32 activations:

    t = x * scale + bias                      # scale: a conv's demodulation, optional
    u = upfirdn2d(t, fu x fu, up, pads, gain up^2)
    v = clamp(lrelu(u, slope) * gain, -clamp, clamp)
    y = upfirdn2d(v, fd x fd, down)

with separable FIRs `fu` and `fd` (1-D taps) and the same pads on both axes.

`filtered_lrelu` launches kernel F (`cuda/csrc/filtered_lrelu.cu`, built by
`cuda/build.py`) for a CUDA tensor: one pass in which each warp walks down a
strip of output columns of a plane, keeps the upsampled rows it still needs
in registers and shared memory only, and writes each output once. Its twin,
`filtered_lrelu_plain`, composes the port's general `upfirdn2d` and
`bias_act`; the wrapper takes it for a CPU tensor. Where autograd may ask for
a gradient (the projector through a StyleGAN3 network), the wrapper goes
through `FilteredLrelu`, whose forward launches F on the card as the
inference path does and whose backward is the twin's vector-Jacobian product
(F has no backward kernel). On a CUDA tensor F cannot take (another dtype,
up/down/taps other than StyleGAN3-T's) the wrapper raises; nothing falls
back. While a profiler runs, the wrapper counts `ops.filtered_lrelu_fused`
(a forward ran F) and `ops.filtered_lrelu_twin` (a forward ran the twin: a
CPU tensor).

F has no counterpart among the JAX package's Pallas kernels: the JAX package
runs no StyleGAN3 network.
"""

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gance_tpu_torch.ops.bias_act import bias_act
from gance_tpu_torch.ops.cuda import fused_ops as _kernels
from gance_tpu_torch.ops.upfirdn2d import upfirdn2d
from gance_tpu_torch.utils import profiling

# (up, down, up taps, down taps) that kernel F is built for: StyleGAN3-T's
# layers (filter_size 6, the leaky ReLU at twice the higher sampling rate)
KERNEL_CASES = ((2, 2, 12, 12), (4, 2, 24, 12))


def output_size(size: int, up: int, down: int, padding: Tuple[int, int], up_taps: int,
                down_taps: int) -> int:
    """Side of the output for an input of side `size`."""
    upsampled = size * up + padding[0] + padding[1] - up_taps + 1
    return (upsampled - down_taps) // down + 1


def strip_lanes(side: int, up: int, down: int, pad: int, down_taps: int) -> int:
    """The lanes of a strip kernel F picks for an output side (its C host's
    rule): a lane makes 8 upsampled columns, so 32 lanes feed strips of at
    most about 120 outputs and 16 of about 56; 16, two planes a warp, where
    that leaves fewer lanes idle over the plane's width."""
    e = (-pad - 1) % up

    def lanes_used(lanes: int) -> int:
        widest = ((lanes * 8 - down_taps - e) // down + 1) // 4 * 4
        return -(-side // widest) * lanes

    return 16 if lanes_used(16) < lanes_used(32) else 32


def filtered_lrelu_plain(
    x: torch.Tensor,
    fu: Optional[Sequence[float]],
    fd: Optional[Sequence[float]],
    bias: torch.Tensor,
    up: int,
    down: int,
    padding: Tuple[int, int],
    gain: float,
    slope: float,
    clamp: Optional[float],
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The twin of kernel F in plain PyTorch, NVlabs' reference order: bias,
    the upsampling `upfirdn2d` (the separable FIR fu times up on each axis:
    gain up^2), bias_act leaky ReLU with gain and clamp, the downsampling
    `upfirdn2d`. A filter of None is the identity."""
    x = x.float()
    if scale is not None:
        x = x * scale.float()[:, :, None, None]
    x = bias_act(x, bias.float())
    k_up = np.ones((1,), np.float32) if fu is None else np.asarray(fu, np.float32)
    x = upfirdn2d(x, k_up * np.float32(up), up=up, pad0=padding[0], pad1=padding[1])
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    k_down = np.ones((1,), np.float32) if fd is None else np.asarray(fd, np.float32)
    return upfirdn2d(x, k_down, down=down)


@functools.lru_cache(maxsize=256)
def _taps_on(taps: Tuple[float, ...], gain: float, device: torch.device) -> torch.Tensor:
    """The correlation taps F reads: the FIR reversed (upfirdn2d convolves),
    times the per-axis gain, as fp32 on `device`; made once per layer."""
    flipped = np.asarray(taps[::-1], np.float32) * np.float32(gain)
    return torch.from_numpy(flipped).to(device)


def filtered_lrelu(
    x: torch.Tensor,
    fu: Optional[Sequence[float]],
    fd: Optional[Sequence[float]],
    bias: torch.Tensor,
    up: int,
    down: int,
    padding: Tuple[int, int],
    gain: float,
    slope: float,
    clamp: Optional[float],
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """
    The filtered leaky ReLU of one StyleGAN3 layer.

    :param x: (B, C, H, W) conv output.
    :param fu: the up filter's 1-D taps (None: identity); `fd` the down filter's.
    :param bias: (C,).
    :param padding: (pad_lo, pad_hi) of the upsampled grid, on both axes.
    :param scale: None, or (B, C) per-sample channel scales applied to x
        first (the conv's demodulation).
    :return: (B, C, S, S) fp32, S = `output_size`.
    """
    b, c, h, w = x.shape
    if h != w or bias.shape != (c,):
        raise ValueError(f"bad shapes x {tuple(x.shape)}, bias {tuple(bias.shape)}")
    if scale is not None and scale.shape != (b, c):
        raise ValueError(f"bad scale shape {tuple(scale.shape)} for x {tuple(x.shape)}")
    spec = (fu, fd, up, down, tuple(padding), gain, slope, clamp)
    grads = (x, bias) if scale is None else (x, bias, scale)
    if _kernels._needs_grad(*grads):
        return FilteredLrelu.apply(x, bias, scale, spec)
    return _filtered_lrelu_run(x, bias, scale, spec)


def _plain(x: torch.Tensor, bias: torch.Tensor, scale: Optional[torch.Tensor],
           spec: tuple) -> torch.Tensor:
    fu, fd, up, down, padding, gain, slope, clamp = spec
    return filtered_lrelu_plain(x, fu, fd, bias, up, down, padding, gain, slope, clamp, scale)


def _filtered_lrelu_run(x: torch.Tensor, bias: torch.Tensor, scale: Optional[torch.Tensor],
                        spec: tuple) -> torch.Tensor:
    """F's forward without autograd: the twin on the CPU, else the kernel."""
    if _kernels._on_cpu(x):
        profiling.count("ops.filtered_lrelu_twin")
        return _plain(x, bias, scale, spec)
    fu, fd, up, down, padding, gain, slope, clamp = spec
    b, c, h, w = x.shape
    case = (up, down, 1 if fu is None else len(fu), 1 if fd is None else len(fd))
    if case not in KERNEL_CASES or clamp is None:
        raise ValueError(f"filtered_lrelu: kernel F takes (up, down, up taps, down taps) in "
                         f"{KERNEL_CASES} with a clamp, got {case}, clamp {clamp}")
    if x.dtype != torch.float32:
        raise TypeError(f"filtered_lrelu: kernel F takes float32, got {x.dtype}")
    side = output_size(h, up, down, padding, case[2], case[3])
    if side <= 0:
        raise ValueError(f"filtered_lrelu: no output for x {tuple(x.shape)}, pads {padding}")
    profiling.count("ops.filtered_lrelu_fused")
    x = x.contiguous()
    bias = _kernels._float32(bias).contiguous()
    scales = () if scale is None else (_kernels._float32(scale).contiguous(),)
    device = _kernels._check("filtered_lrelu", x, bias, *scales)
    ku = _taps_on(tuple(float(t) for t in fu), float(up), x.device)
    kd = _taps_on(tuple(float(t) for t in fd), 1.0, x.device)
    out = x.new_empty((b, c, side, side))
    _kernels._launch(
        "filtered_lrelu", "filtered_lrelu", device,
        x.data_ptr(), bias.data_ptr(), scales[0].data_ptr() if scales else None,
        ku.data_ptr(), kd.data_ptr(), out.data_ptr(),
        b, c, h, w, side, side, up, down, int(padding[0]),
        float(gain), float(slope), float(clamp),
    )
    return out


class FilteredLrelu(torch.autograd.Function):
    """Kernel F where a gradient may be asked for: the forward is
    `_filtered_lrelu_run` (F on a CUDA tensor, the twin on a CPU tensor);
    the backward recomputes the twin from the saved inputs and returns its
    vector-Jacobian product (`torch.func.vjp`), so a second order
    differentiates the twin again. F has no backward kernel."""

    @staticmethod
    def forward(ctx, x, bias, scale, spec):  # pylint: disable=arguments-differ
        ctx.spec = spec
        ctx.save_for_backward(x, bias, scale)
        return _filtered_lrelu_run(x, bias, scale, spec)

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        x, bias, scale = ctx.saved_tensors
        if scale is None:
            _, vjp = torch.func.vjp(lambda x_, b_: _plain(x_, b_, None, ctx.spec), x, bias)
            gx, gbias = vjp(g)
            gscale = None
        else:
            _, vjp = torch.func.vjp(lambda x_, b_, s_: _plain(x_, b_, s_, ctx.spec),
                                    x, bias, scale)
            gx, gbias, gscale = vjp(g)
        return gx, gbias, gscale, None
