"""
The three synthesis kernels, each as a wrapper, a plain PyTorch twin and a
launch count.

A wrapper takes its twin only when the tensor it is given lies on the CPU. For
a CUDA tensor it launches the hand-written kernel (`csrc/`, built by
`build.py`) on the current stream or raises; nothing falls back. `LAUNCHES`
counts kernel launches, one per call that reached a kernel.

| wrapper | replaces (gance_tpu/ops/pallas/fused_ops.py) | source |
| --- | --- | --- |
| fused_bias_noise_lrelu | fused_bias_noise_lrelu (pallas_call :69) | csrc/fused_bias_noise_lrelu.cu |
| upsample2x_blur | upsample2x_blur (pallas_call :152) | csrc/upsample2x_blur.cu |
| blur4_separable_pad11 | blur4_separable_pad11 (pallas_call :333, :350) | csrc/blur4_separable.cu |

All three are memory-bound on the H100; each source file states its bound and
design. Every kernel takes NCHW-contiguous fp32 or bf16 activations and
computes in fp32.
"""

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.cuda import build

LAUNCHES: Dict[str, int] = {
    "fused_bias_noise_lrelu": 0,
    "upsample2x_blur": 0,
    "blur4_separable_pad11": 0,
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SQRT2 = math.sqrt(2.0)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (use the twin); False for CUDA; raises otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(name: str, library: str, *args) -> None:
    rc = build.load(library)(*args, torch.cuda.current_stream().cuda_stream)
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
    if _on_cpu(x):
        return fused_bias_noise_lrelu_plain(x, noise, bias, strength)
    noise = noise.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    strength = strength.to(torch.float32).reshape(()).contiguous()
    _check("fused_bias_noise_lrelu", x, noise, bias, strength)
    out = torch.empty_like(x)
    _launch(
        "fused_bias_noise_lrelu", "fused_bias_noise_lrelu",
        x.data_ptr(), noise.data_ptr(), bias.data_ptr(), strength.data_ptr(),
        out.data_ptr(), b * c, c, h * w, int(noise.shape[0] != 1),
        _DTYPE_CODES[x.dtype],
    )
    return out


# ---------------------------------------------------------------------------
# B. 2x polyphase upsample with the [1,3,3,1] FIR
# ---------------------------------------------------------------------------


def upsample2x_blur_plain(x: torch.Tensor) -> torch.Tensor:
    """
    The twin of kernel B: the polyphase 2x upsample of
    gance_tpu/ops/upfirdn2d.py::upsample2x_polyphase_nchw in fp32,
    (B, C, H, W) -> (B, C, 2H, 2W), output in x's dtype.
    """
    b, c, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    left, mid, right = xp[..., :-2], xp[..., 1:-1], xp[..., 2:]
    h_even = 0.25 * left + 0.75 * mid
    h_odd = 0.75 * mid + 0.25 * right
    hs = torch.stack([h_even, h_odd], dim=-1).reshape(b, c, h + 2, 2 * w)
    up, vmid, down = hs[:, :, :-2], hs[:, :, 1:-1], hs[:, :, 2:]
    v_even = 0.25 * up + 0.75 * vmid
    v_odd = 0.75 * vmid + 0.25 * down
    return torch.stack([v_even, v_odd], dim=3).reshape(b, c, 2 * h, 2 * w).to(x.dtype)


def upsample2x_blur(x: torch.Tensor) -> torch.Tensor:
    """2x FIR upsample with the [1,3,3,1] binomial: (B, C, H, W) -> (B, C, 2H, 2W)."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    if _on_cpu(x):
        return upsample2x_blur_plain(x)
    _check("upsample2x_blur", x)
    b, c, h, w = x.shape
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    _launch(
        "upsample2x_blur", "upsample2x_blur",
        x.data_ptr(), out.data_ptr(), b * c, h, w, _DTYPE_CODES[x.dtype],
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
    upfirdn2d(x[..., :w_logical], outer(taps, taps), pad0=1, pad1=1) as one
    separable pass: x (B, C, H, Wp) -> (B, C, H-1, w_logical-1). Columns at or
    past `w_logical` are never read. The taps are applied as a correlation, as
    in the Pallas kernel; for the symmetric resampling FIRs of StyleGAN2 that
    equals the true convolution.
    """
    if x.ndim != 4 or len(taps) != 4:
        raise ValueError(f"expected NCHW input and 4 taps, got {tuple(x.shape)}, {taps}")
    b, c, h, wp = x.shape
    w_logical = wp if w_logical is None else int(w_logical)
    if not 2 <= w_logical <= wp or h < 2:
        raise ValueError(f"bad w_logical {w_logical} for shape {tuple(x.shape)}")
    if _on_cpu(x):
        return blur4_separable_pad11_plain(x, taps, w_logical)
    _check("blur4_separable_pad11", x)
    out = torch.empty((b, c, h - 1, w_logical - 1), dtype=x.dtype, device=x.device)
    _launch(
        "blur4_separable_pad11", "blur4_separable",
        x.data_ptr(), out.data_ptr(), b * c, h, wp, w_logical,
        *(float(t) for t in taps), _DTYPE_CODES[x.dtype],
    )
    return out
