"""
The port's five kernels, each as a wrapper, a plain PyTorch twin and a launch
count.

A wrapper takes its twin only when the tensor it is given lies on the CPU. For
a CUDA tensor it launches the hand-written kernel (`csrc/`, built by
`build.py`) on the current stream or raises; nothing falls back. `LAUNCHES`
counts kernel launches, one per call that reached a kernel, forward or
backward.

| wrapper | replaces (in gance_tpu/ops/pallas/) | source (in csrc/) |
| --- | --- | --- |
| A fused_bias_noise_lrelu | fused_ops.py (pallas_call :69) | fused_bias_noise_lrelu.cu |
| B upsample2x_blur | fused_ops.py (pallas_call :152) | upsample2x_blur.cu |
| C blur4_separable_pad11 | fused_ops.py (pallas_call :333, :350) | blur4_separable.cu |
| D stencil_blur4_valid | fused_ops.py (pallas_call :447) | stencil_blur4_valid.cu |
| E phase_conv1_torgb | phase_fused.py::phase_conv1_torgb_fused (pallas_call :143) | phase_conv1_torgb.cu |

Where a gradient may be asked for (grad enabled and an input that requires
it), every wrapper goes through its `torch.autograd.Function` in `autograd.py`
on both devices, so gradients of every order pass through the kernels (E's
backward is plain PyTorch, as in the JAX package, whose phase path is XLA
under grad). Otherwise (`torch.inference_mode`, `torch.no_grad`, or no input
that requires grad) it calls the Function's forward, `_*_run`, directly: the
same output without the Function's per-call cost. The launch path is kept
lean for the small layers, whose time is host time: no device object is
built, and the stream is PyTorch's current raw stream. A-D are memory-bound
on the H100, E is bound by its operations; each source file states its bound
and design. Every kernel takes
NCHW-contiguous fp32 or bf16 activations and sums in fp32.
"""

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.cuda import autograd as _autograd
from gance_tpu_torch.ops.cuda import build
from gance_tpu_torch.ops.precision import exact_fp32

LAUNCHES: Dict[str, int] = {
    "fused_bias_noise_lrelu": 0,
    "upsample2x_blur": 0,
    "blur4_separable_pad11": 0,
    "stencil_blur4_valid": 0,
    "phase_conv1_torgb": 0,
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SQRT2 = math.sqrt(2.0)
RGB_COLUMNS = 16  # kernel E's ToRGB width: 4 phases x up to 4 channels, zero-padded
MAX_PHASE_CHANNELS = 512  # kernel E's largest C4 (its z tile lives in shared memory)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (use the twin); False for CUDA; raises otherwise."""
    if x.is_cpu:
        return True
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    return False


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd may ask for a gradient of the result: grad enabled
    and some input requires grad. The wrappers take their Function then."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _float32(t: torch.Tensor) -> torch.Tensor:
    """t in fp32; t itself when it is (`Tensor.to` costs microseconds even then)."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _check(name: str, x: torch.Tensor, *others: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return x's device index."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    device = x.get_device()
    if device != torch._C._cuda_getDevice():
        raise ValueError(f"{name}: tensor on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in (x, *others):
        if t.get_device() != device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return device


def _launch(name: str, library: str, device: int, *args) -> None:
    """Launch on PyTorch's current stream of `device` (its raw handle, no
    Stream object)."""
    rc = build.load(library)(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# A. noise + bias + leaky relu epilogue
# ---------------------------------------------------------------------------


def fused_bias_noise_lrelu_plain(
    x: torch.Tensor, noise: torch.Tensor, bias: torch.Tensor, strength: torch.Tensor
) -> torch.Tensor:
    """The twin of kernel A: same fp32 arithmetic, output in x's dtype."""
    pre = (
        x.float()
        + noise.float() * strength.float()
        + bias.float().reshape(1, -1, 1, 1)
    )
    return (torch.where(pre >= 0, pre, pre * 0.2) * _SQRT2).to(x.dtype)


def fused_bias_noise_lrelu(
    x: torch.Tensor, noise: torch.Tensor, bias: torch.Tensor, strength: torch.Tensor
) -> torch.Tensor:
    """
    lrelu(x + noise * strength + bias, 0.2) * sqrt(2) in one pass.

    :param x: (B, C, H, W) fp32 or bf16.
    :param noise: (1, 1, H, W) constant noise, or (B, 1, H, W) per-sample noise.
    :param bias: (C,).
    :param strength: 0-d tensor; the kernel reads it on the device (no sync).
    """
    b, c, h, w = x.shape
    if noise.shape not in ((1, 1, h, w), (b, 1, h, w)) or bias.shape != (c,):
        raise ValueError(f"bad shapes x {tuple(x.shape)}, noise {tuple(noise.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if strength.numel() != 1:
        raise ValueError("strength must hold one value")
    strength = _float32(strength)
    args = (x, _float32(noise), _float32(bias),
            strength.reshape(()) if strength.dim() else strength)
    if _needs_grad(*args):
        return _autograd.FusedBiasNoiseLrelu.apply(*args)
    return _fused_bias_noise_lrelu_run(*args)


def _fused_bias_noise_lrelu_run(
    x: torch.Tensor, noise: torch.Tensor, bias: torch.Tensor, strength: torch.Tensor
) -> torch.Tensor:
    """A's forward without autograd: the twin on the CPU, else the kernel."""
    if _on_cpu(x):
        return fused_bias_noise_lrelu_plain(x, noise, bias, strength)
    b, c, h, w = x.shape
    noise, bias, strength = noise.contiguous(), bias.contiguous(), strength.contiguous()
    device = _check("fused_bias_noise_lrelu", x, noise, bias, strength)
    out = torch.empty_like(x)
    _launch(
        "fused_bias_noise_lrelu", "fused_bias_noise_lrelu", device,
        x.data_ptr(), noise.data_ptr(), bias.data_ptr(), strength.data_ptr(),
        out.data_ptr(), b * c, c, h * w, int(noise.shape[0] != 1),
        _DTYPE_CODES[x.dtype],
    )
    return out


# ---------------------------------------------------------------------------
# B. 2x polyphase upsample with a separable 4-tap FIR
# ---------------------------------------------------------------------------


def _four_taps(taps: Sequence[float]) -> Tuple[float, float, float, float]:
    if len(taps) != 4:
        raise ValueError(f"expected 4 taps, got {taps}")
    k0, k1, k2, k3 = (float(t) for t in taps)
    return k0, k1, k2, k3


def upsample2x_blur_plain(x: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """
    The twin of kernel B: the polyphase 2x upsample of
    gance_tpu/ops/upfirdn2d.py::upsample2x_polyphase_nchw in fp32,
    (B, C, H, W) -> (B, C, 2H, 2W), output in x's dtype. Even phases are
    k0*x[i-1] + k2*x[i], odd phases k1*x[i] + k3*x[i+1], first along W, then H.
    """
    k0, k1, k2, k3 = _four_taps(taps)
    b, c, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    left, mid, right = xp[..., :-2], xp[..., 1:-1], xp[..., 2:]
    h_even = k0 * left + k2 * mid
    h_odd = k1 * mid + k3 * right
    hs = torch.stack([h_even, h_odd], dim=-1).reshape(b, c, h + 2, 2 * w)
    up, vmid, down = hs[:, :, :-2], hs[:, :, 1:-1], hs[:, :, 2:]
    v_even = k0 * up + k2 * vmid
    v_odd = k1 * vmid + k3 * down
    return torch.stack([v_even, v_odd], dim=3).reshape(b, c, 2 * h, 2 * w).to(x.dtype)


def upsample2x_blur(x: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """2x FIR upsample with the polyphase taps (k0, k1, k2, k3) of a separable
    4-tap FIR ((.25, .75, .75, .25) for [1,3,3,1]): (B, C, H, W) -> (B, C, 2H, 2W)."""
    taps = _four_taps(taps)
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    if _needs_grad(x):
        return _autograd.Upsample2xBlur.apply(x, taps)
    return _upsample2x_blur_run(x, taps)


def _upsample2x_blur_run(x: torch.Tensor, taps: Tuple[float, ...]) -> torch.Tensor:
    """B's forward without autograd: the twin on the CPU, else the kernel."""
    if _on_cpu(x):
        return upsample2x_blur_plain(x, taps)
    device = _check("upsample2x_blur", x)
    b, c, h, w = x.shape
    out = x.new_empty((b, c, 2 * h, 2 * w))
    _launch(
        "upsample2x_blur", "upsample2x_blur", device,
        x.data_ptr(), out.data_ptr(), b * c, h, w, *taps, _DTYPE_CODES[x.dtype],
    )
    return out


# ---------------------------------------------------------------------------
# C. separable 4-tap blur, pad 1, after the transpose conv
# ---------------------------------------------------------------------------


def blur4_separable_pad11_plain(
    x: torch.Tensor, taps: Sequence[float], w_logical: Optional[int] = None
) -> torch.Tensor:
    """The twin of kernel C: vertical then horizontal 4-tap pass in fp32."""
    w_logical = x.shape[3] if w_logical is None else w_logical
    k0, k1, k2, k3 = (float(t) for t in taps)
    xp = F.pad(x[..., :w_logical].float(), (1, 1, 1, 1))
    vt = k0 * xp[:, :, :-3] + k1 * xp[:, :, 1:-2] + k2 * xp[:, :, 2:-1] + k3 * xp[:, :, 3:]
    out = (
        k0 * vt[..., :-3] + k1 * vt[..., 1:-2] + k2 * vt[..., 2:-1] + k3 * vt[..., 3:]
    )
    return out.to(x.dtype)


def blur4_separable_pad11(
    x: torch.Tensor, taps: Sequence[float], w_logical: Optional[int] = None
) -> torch.Tensor:
    """
    The separable 4-tap FIR with pad 1 as one pass: x (B, C, H, Wp) ->
    (B, C, H-1, w_logical-1), out[i][j] = sum_a sum_b taps[a] * taps[b] *
    xp[i+a][j+b] with xp the zero-padded x[..., :w_logical]. Columns at or past
    `w_logical` are never read. The taps are applied as a correlation, as in
    the Pallas kernel: for upfirdn2d's true convolution with a FIR root r, pass
    r reversed (`upsample_conv_2d` does).
    """
    taps = _four_taps(taps)
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got {tuple(x.shape)}")
    b, c, h, wp = x.shape
    w_logical = wp if w_logical is None else int(w_logical)
    if not 2 <= w_logical <= wp or h < 2:
        raise ValueError(f"bad w_logical {w_logical} for shape {tuple(x.shape)}")
    if _needs_grad(x):
        return _autograd.Blur4SeparablePad11.apply(x, taps, w_logical)
    return _blur4_separable_pad11_run(x, taps, w_logical)


def _blur4_separable_pad11_run(
    x: torch.Tensor, taps: Tuple[float, ...], w_logical: int
) -> torch.Tensor:
    """C's forward without autograd: the twin on the CPU, else the kernel."""
    if _on_cpu(x):
        return blur4_separable_pad11_plain(x, taps, w_logical)
    b, c, h, wp = x.shape
    device = _check("blur4_separable_pad11", x)
    out = x.new_empty((b, c, h - 1, w_logical - 1))
    _launch(
        "blur4_separable_pad11", "blur4_separable", device,
        x.data_ptr(), out.data_ptr(), b * c, h, wp, w_logical,
        *taps, _DTYPE_CODES[x.dtype],
    )
    return out


# ---------------------------------------------------------------------------
# D. general 4x4 FIR as a correlation over an implicitly padded input
# ---------------------------------------------------------------------------


def _sixteen_taps(taps: Sequence) -> Tuple[float, ...]:
    """A 4x4 FIR (nested or flat, row-major) as 16 fp32-rounded Python floats.
    A flat tuple (the resample plans' and the backward passes' form) is
    converted once and kept."""
    if isinstance(taps, tuple) and len(taps) == 16:
        return _sixteen_taps_kept(taps)
    return _sixteen_taps_of(taps)


def _sixteen_taps_of(taps: Sequence) -> Tuple[float, ...]:
    flat = np.asarray(taps, dtype=np.float32).reshape(-1)
    if flat.size != 16:
        raise ValueError(f"expected a 4x4 FIR, got {np.shape(taps)}")
    return tuple(float(v) for v in flat)


_sixteen_taps_kept = functools.lru_cache(maxsize=256)(_sixteen_taps_of)


@functools.lru_cache(maxsize=256)
def _c_taps(taps: Tuple[float, ...]) -> ctypes.Array:
    """The 16 taps as the C array kernel D reads (during the call only)."""
    return (ctypes.c_float * 16)(*taps)


def _pads(pads: Sequence[int]) -> Tuple[int, int]:
    p0, p1 = (int(p) for p in pads)
    if not (0 <= p0 <= 3 and 0 <= p1 <= 3):
        raise ValueError(f"pads {tuple(pads)} must each lie in [0, 3]")
    return p0, p1


def stencil_blur4_valid_plain(
    x: torch.Tensor, taps: Sequence, pads: Sequence[int] = (0, 0)
) -> torch.Tensor:
    """The twin of kernel D: pad, then the 16 products summed in fp32 in
    row-major tap order, as the kernel sums them; output in x's dtype."""
    k = _sixteen_taps(taps)
    p0, p1 = _pads(pads)
    xp = F.pad(x.float(), (p0, p1, p0, p1))
    ho, wo = xp.shape[2] - 3, xp.shape[3] - 3
    acc = k[0] * xp[:, :, :ho, :wo]
    for t in range(1, 16):
        a, b = divmod(t, 4)
        acc = acc + k[t] * xp[:, :, a:a + ho, b:b + wo]
    return acc.to(x.dtype)


def stencil_blur4_valid(
    x: torch.Tensor, taps: Sequence, pads: Sequence[int] = (0, 0)
) -> torch.Tensor:
    """
    out[i][j] = sum_a sum_b taps[a][b] * xp[i+a][j+b]: a general 4x4 FIR
    applied as a correlation, as in the Pallas kernel (for upfirdn2d's true
    convolution pass the FIR flipped), over x (B, C, H, W) zero-padded by
    pads[0] before and pads[1] after on both axes, each pad in [0, 3]. The
    pad is implicit: the padded copy is never made. Returns
    (B, C, H+p0+p1-3, W+p0+p1-3) in x's dtype. pads (0, 0) is the Pallas
    function's contract on an input the caller padded.
    """
    k = _sixteen_taps(taps)
    p0, p1 = _pads(pads)
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    if min(x.shape[2], x.shape[3]) + p0 + p1 < 4:
        raise ValueError(f"input {tuple(x.shape)} with pads {(p0, p1)} is smaller than the FIR")
    if _needs_grad(x):
        return _autograd.StencilBlur4Valid.apply(x, k, (p0, p1))
    return _stencil_blur4_valid_run(x, k, (p0, p1))


def _stencil_blur4_valid_run(
    x: torch.Tensor, taps: Tuple[float, ...], pads: Tuple[int, int]
) -> torch.Tensor:
    """D's forward without autograd: the twin on the CPU, else the kernel."""
    if _on_cpu(x):
        return stencil_blur4_valid_plain(x, taps, pads)
    device = _check("stencil_blur4_valid", x)
    b, c, h, w = x.shape
    p0, p1 = pads
    out = x.new_empty((b, c, h + p0 + p1 - 3, w + p0 + p1 - 3))
    _launch(
        "stencil_blur4_valid", "stencil_blur4_valid", device,
        x.data_ptr(), out.data_ptr(), b * c, h, w, p0, p1, _c_taps(taps),
        _DTYPE_CODES[x.dtype],
    )
    return out


# ---------------------------------------------------------------------------
# E. phase-space Conv1 + demod/noise/bias/lrelu + ToRGB of the top block
# ---------------------------------------------------------------------------


def fold_conv1_weights(v: torch.Tensor) -> torch.Tensor:
    """
    Fold a 3x3 SAME conv on the fine grid into a 2x2 conv on the phase planes:
    OIHW (cout, cin, 3, 3) -> (4*cout, 4*cin, 2, 2). Output sigma=0 planes hold
    fine rows 2m, sigma=1 planes fine rows 2m-1; with padding 1 the output is
    (H/2+1) x (W/2+1).

    Per axis, output phase sigma at position m (fine 2m - sigma) takes tap d
    from fine 2m - sigma + d - 1 = 2 (m + kh - 1) + delta: input phase delta
    at kernel row kh, where 2 kh + delta = d + 1 - sigma. So on the 4 x 4 grid
    of (2 kh + delta_h, 2 kw + delta_w), phase sigma's blocks are v shifted by
    1 - sigma and zero elsewhere: each block is one tap or zero (28 of 64).

    :param v: OIHW (cout, cin, 3, 3), already runtime-scaled.
    """
    cout, cin, kh, kw = v.shape
    if (kh, kw) != (3, 3):
        raise ValueError("phase conv1 fold requires a 3x3 conv weight")
    grids = torch.stack([F.pad(v, (1 - sig_w, sig_w, 1 - sig_h, sig_h))
                         for sig_h in range(2) for sig_w in range(2)])
    grids = grids.reshape(4, cout, cin, 2, 2, 2, 2)  # (out_ph, o, c, kh, delta_h, kw, delta_w)
    return grids.permute(0, 1, 4, 6, 2, 3, 5).reshape(4 * cout, 4 * cin, 2, 2)


def unfold_conv1_weights(w4: torch.Tensor) -> torch.Tensor:
    """The nine taps of a Conv1 fold, (4*cout, 4*cin, 2, 2) -> OIHW (cout, cin,
    3, 3): exact copies of output phase 0's nine non-zero blocks, which sit at
    2 kh + delta = d + 1 on each axis. For a w4 that is not a fold,
    `fold_conv1_weights` of the result differs from w4."""
    cout, cin = w4.shape[0] // 4, w4.shape[1] // 4
    grid = w4[:cout].reshape(cout, 2, 2, cin, 2, 2).permute(0, 3, 4, 1, 5, 2)
    return grid.reshape(cout, cin, 4, 4)[:, :, 1:, 1:]  # (o, c, kh, delta_h, kw, delta_w)


def _phase_epilogue_torgb(acc: torch.Tensor, demod: torch.Tensor, noise_bias: torch.Tensor,
                          wrgb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """E's epilogue on fp32 sums acc (B, 4C, H+1, W+1): z = lrelu(acc * demod +
    noise_bias) rounded to `dtype`, then the ToRGB product in fp32."""
    z = acc * demod.float()[:, :, None, None] + noise_bias.to(dtype).float()
    z = torch.maximum(z, z * 0.2).to(dtype).float()
    return torch.einsum("bchw,bck->bkhw", z, wrgb.to(dtype).float()).to(dtype)


def phase_conv1_torgb_plain(
    x: torch.Tensor,
    w4: torch.Tensor,
    demod: torch.Tensor,
    noise_bias: torch.Tensor,
    wrgb: torch.Tensor,
) -> torch.Tensor:
    """
    The twin of kernel E, in the kernel's arithmetic: the operands are taken in
    x's dtype, the conv and the ToRGB product sum in fp32 (never TF32), z is
    rounded to x's dtype before the ToRGB product, and the output is in x's
    dtype. The conv is the dense folded one, for any w4.
    """
    dtype = x.dtype
    with exact_fp32():
        acc = F.conv2d(x.float(), w4.to(dtype).float(), padding=1)
        return _phase_epilogue_torgb(acc, demod, noise_bias, wrgb, dtype)


def phases_to_fine(t: torch.Tensor) -> torch.Tensor:
    """Phase planes (B, 4C, H, W), channel (dh * 2 + dw) * C + c, interleaved
    to the fine grid (B, C, 2H, 2W): fine[2m + dh][2n + dw] = t[dh, dw][m][n]."""
    b, c4, h, w = t.shape
    return t.reshape(b, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2).reshape(
        b, c4 // 4, 2 * h, 2 * w)


def fine_to_phases(t: torch.Tensor) -> torch.Tensor:
    """The inverse of `phases_to_fine`: (B, C, 2H, 2W) -> (B, 4C, H, W)."""
    b, c, h2, w2 = t.shape
    return t.reshape(b, c, h2 // 2, 2, w2 // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(
        b, 4 * c, h2 // 2, w2 // 2)


def _conv_phases_of_fine(acc_fine: torch.Tensor) -> torch.Tensor:
    """E's output phases from the 3x3 conv on the fine grid padded by 2
    (B, C, 2H+2, 2W+2): phase sigma at m is fine pixel 2m + 1 - sigma, the
    phases of `fine_to_phases` in reverse order."""
    b, c, h2, w2 = acc_fine.shape
    return fine_to_phases(acc_fine).reshape(b, 4, c, h2 // 2, w2 // 2).flip(1).reshape(
        b, 4 * c, h2 // 2, w2 // 2)


def _fine_of_conv_phases(acc: torch.Tensor) -> torch.Tensor:
    """The inverse of `_conv_phases_of_fine`."""
    b, c4, h, w = acc.shape
    return phases_to_fine(acc.reshape(b, 4, c4 // 4, h, w).flip(1).reshape(b, c4, h, w))


def phase_conv1_torgb_taps_plain(
    x: torch.Tensor,
    v: torch.Tensor,
    demod: torch.Tensor,
    noise_bias: torch.Tensor,
    wrgb: torch.Tensor,
) -> torch.Tensor:
    """
    Kernel E's index map in plain PyTorch: the nine taps v (C, C, 3, 3) of the
    fold, applied as the kernel applies them. The phase planes interleave to
    the fine grid, padded by 2: halo[i][j] = x[(i%2)*2 + j%2][i//2 - 1][j//2 - 1].
    Fine pixel a of the 3x3 conv over it reads halo[a + dh], and output phase
    sigma at position m is fine pixel a = 2m + 1 - sigma. Equals the twin on
    `fold_conv1_weights(v)` up to the order of the fp32 sums.
    """
    dtype = x.dtype
    with exact_fp32():
        acc_fine = F.conv2d(phases_to_fine(x).float(), v.to(dtype).float(), padding=2)
        return _phase_epilogue_torgb(_conv_phases_of_fine(acc_fine), demod, noise_bias, wrgb,
                                     dtype)


# Kernel E's padding of the taps (csrc/phase_conv1_torgb.cu): input channels
# to whole chunks, output channels to whole slabs.
_PHASE_CHUNK = {torch.float32: 8, torch.bfloat16: 16}
_PHASE_SLAB = 64


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def phase_conv1_torgb(
    x: torch.Tensor,
    w4: torch.Tensor,
    demod: torch.Tensor,
    noise_bias: torch.Tensor,
    wrgb: torch.Tensor,
) -> torch.Tensor:
    """
    rgb[b] = lrelu(conv2d(x[b], w4, pad 1) * demod[b] + noise_bias, 0.2) @ wrgb[b]
    in one pass; the activated (B, C4, H+1, W+1) tensor is never stored.

    w4 must be a Conv1 fold, `fold_conv1_weights(v)` of a 3x3 weight v: the
    kernel takes only v's nine taps (`unfold_conv1_weights`), shared by the
    four output phases, and never reads the 28 zero blocks of 64. A w4 that
    is not a fold raises ValueError on the CPU; on the card a device-side
    assert (no host sync) stops the stream. The CPU runs the dense twin.
    The kernel reads NCHW x itself in both dtypes (bf16 transposes its halo
    to pixel-major on the way into shared memory); the wrapper only lays the
    taps out as (C, 9, C), padded to whole chunks and slabs. Bound: the
    9C-term conv and the ToRGB product, 6.2e11 flops at 1024px batch 8
    (csrc/phase_conv1_torgb.cu).

    :param x: (B, C4, H, W) phase planes, activated and scaled by Conv1's style.
    :param w4: (C4, C4, 2, 2) OIHW, Conv1 folded into phase space.
    :param demod: (B, C4) Conv1's demodulation, tiled over the four phases.
    :param noise_bias: (1 or B, C4, H+1, W+1): noise * strength + bias.
    :param wrgb: (B, C4, 16) phase-diagonal ToRGB with sqrt(2) * s_rgb folded
        in; columns past 4 * channels are zero.
    :return: (B, 16, H+1, W+1) RGB phase planes in x's dtype.
    """
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    b, c4, h, w = x.shape
    if (
        w4.shape != (c4, c4, 2, 2)
        or demod.shape != (b, c4)
        or noise_bias.shape not in ((1, c4, h + 1, w + 1), (b, c4, h + 1, w + 1))
        or wrgb.shape != (b, c4, RGB_COLUMNS)
    ):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)}, w4 {tuple(w4.shape)}, demod "
            f"{tuple(demod.shape)}, noise_bias {tuple(noise_bias.shape)}, wrgb {tuple(wrgb.shape)}"
        )
    if c4 % 4 or c4 > MAX_PHASE_CHANNELS:
        raise ValueError(f"C4={c4} must be a multiple of 4 and at most {MAX_PHASE_CHANNELS}")
    if _needs_grad(x, w4, demod, noise_bias, wrgb):
        return _autograd.PhaseConv1Torgb.apply(x, w4, demod, noise_bias, wrgb)
    return _phase_conv1_torgb_run(x, w4, demod, noise_bias, wrgb)


def _phase_conv1_torgb_run(
    x: torch.Tensor,
    w4: torch.Tensor,
    demod: torch.Tensor,
    noise_bias: torch.Tensor,
    wrgb: torch.Tensor,
) -> torch.Tensor:
    """E's forward without autograd: the twin on the CPU, else the kernel."""
    b, c4, h, w = x.shape
    on_cpu = _on_cpu(x)
    v = unfold_conv1_weights(w4)
    if on_cpu:
        if not torch.equal(fold_conv1_weights(v), w4):
            raise ValueError("phase_conv1_torgb: w4 is not a Conv1 fold "
                             "(fold_conv1_weights of a 3x3 weight)")
        return phase_conv1_torgb_plain(x, w4, demod, noise_bias, wrgb)
    dtype = x.dtype
    demod = demod.to(torch.float32).contiguous()
    noise_bias = noise_bias.to(dtype).contiguous()
    wrgb = wrgb.to(dtype).contiguous()
    device = _check("phase_conv1_torgb", x, w4.contiguous(), demod, noise_bias, wrgb)
    c = c4 // 4
    cin_pad, cout_pad = _round_up(c, _PHASE_CHUNK[dtype]), _round_up(c, _PHASE_SLAB)
    wv = v.to(dtype).permute(1, 2, 3, 0).reshape(c, 9, c)  # [in][dh * 3 + dw][out]
    wv = F.pad(wv, (0, cout_pad - c, 0, 0, 0, cin_pad - c)).contiguous()
    torch._assert_async((fold_conv1_weights(v) == w4).all())  # w4 is a fold; no host sync
    out = x.new_empty((b, RGB_COLUMNS, h + 1, w + 1))
    _launch(
        "phase_conv1_torgb", "phase_conv1_torgb", device,
        x.data_ptr(), wv.data_ptr(), demod.data_ptr(), noise_bias.data_ptr(),
        wrgb.data_ptr(), out.data_ptr(), b, c4, h, w, int(noise_bias.shape[0] != 1),
        _DTYPE_CODES[dtype],
    )
    return out
