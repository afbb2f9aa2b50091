"""
Style-modulated 2-D convolution, the core StyleGAN2 synthesis op, on NCHW
activations and OIHW weights.

    s  = affine(style_w) + 1                       # per-sample input-channel scales
    d  = rsqrt(sum_{i,kh,kw} (w * s[i])^2 + 1e-8)  # per-sample demod per output
    y  = d * conv(x * s, w)                        # conv may upsample

As in gance_tpu/ops/modulated_conv.py the non-fused form is used: scale the
input channels, run one conv with the weight shared across the batch, scale
the output channels. Stored weights keep the TF checkpoint's "unit"
parameterization; the equalized-LR coefficient is applied here. The style and
demod dots always run in exact fp32, whatever the conv precision tier.
StyleGAN3 (models/stylegan3.py) makes its own styles and weights and enters
at `styled_conv2d`, the same route from the styles on.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.precision import exact_fp32
from gance_tpu_torch.ops.upfirdn2d import (
    DEFAULT_RESAMPLE_KERNEL,
    conv_downsample_2d,
    upsample_conv_2d,
)


def runtime_weight_coef(fan_in: int, gain: float = 1.0, lrmul: float = 1.0) -> float:
    """Equalized-LR runtime coefficient: he_std * lrmul (use_wscale=True)."""
    return float(gain / np.sqrt(fan_in) * lrmul)


def style_vector(
    style_w: torch.Tensor, mod_weight: torch.Tensor, mod_bias: torch.Tensor
) -> torch.Tensor:
    """Style affine: s = w @ (mod_weight * coef) + bias + 1, fp32 (B, Cin)."""
    mod_coef = runtime_weight_coef(mod_weight.shape[0])
    with exact_fp32():
        s = style_w.float() @ (mod_weight.float() * mod_coef)
    return s + mod_bias.float() + 1.0


def demod_vector(styles: torch.Tensor, w_scaled: torch.Tensor,
                 w_sq_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d[b, o] = rsqrt(sum_i s[b, i]^2 * sum_khw w[o, i]^2 + 1e-8); `w_scaled` is
    the runtime-scaled fp32 OIHW weight, `w_sq_sum` its (Cout, Cin) sums of
    squares where the caller keeps them."""
    if w_sq_sum is None:
        w_sq_sum = w_scaled.square().sum(dim=(2, 3))  # (Cout, Cin)
    with exact_fp32():
        return torch.rsqrt(styles.square() @ w_sq_sum.t() + 1e-8)


def modulated_conv2d(
    x: torch.Tensor,
    style_w: torch.Tensor,
    weight: torch.Tensor,
    mod_weight: torch.Tensor,
    mod_bias: torch.Tensor,
    up: bool = False,
    demodulate: bool = True,
    resample_kernel: Tuple[int, ...] = DEFAULT_RESAMPLE_KERNEL,
    compute_dtype: Optional[torch.dtype] = None,
    down: bool = False,
) -> torch.Tensor:
    """
    :param x: activations (B, Cin, H, W).
    :param style_w: per-sample dlatent row (B, W_DIM) feeding the style affine.
    :param weight: conv weight (Cout, Cin, kh, kw), unit parameterization.
    :param mod_weight: style affine weight (W_DIM, Cin), unit parameterization.
    :param mod_bias: style affine bias (Cin,); +1 applied per StyleGAN2.
    :param up: 2x upsample fused with the conv (transpose conv + FIR).
    :param down: 2x downsample fused with the conv (FIR + strided conv).
    :param demodulate: apply weight demodulation (off for ToRGB).
    :return: (B, Cout, H', W') in `compute_dtype` (x's dtype by default).
    """
    y, demod = modulated_conv2d_undemodulated(
        x, style_w, weight, mod_weight, mod_bias, up=up, demodulate=demodulate,
        resample_kernel=resample_kernel, compute_dtype=compute_dtype, down=down,
    )
    if demod is not None:
        y = y * demod[:, :, None, None].to(y.dtype)
    return y


def modulated_conv2d_undemodulated(
    x: torch.Tensor,
    style_w: torch.Tensor,
    weight: torch.Tensor,
    mod_weight: torch.Tensor,
    mod_bias: torch.Tensor,
    up: bool = False,
    demodulate: bool = True,
    resample_kernel: Tuple[int, ...] = DEFAULT_RESAMPLE_KERNEL,
    compute_dtype: Optional[torch.dtype] = None,
    down: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """modulated_conv2d's conv and its demodulation d (B, Cout) fp32 (None
    without `demodulate`), d not applied: the synthesis layers that end in
    kernel A hand it d as A's `scale`."""
    _, cin, kh, kw = weight.shape
    styles = style_vector(style_w, mod_weight, mod_bias)  # (B, Cin)
    w = weight.float() * runtime_weight_coef(kh * kw * cin)
    return styled_conv2d(x, styles, w, demodulate=demodulate, up=up, down=down,
                         resample_kernel=resample_kernel, compute_dtype=compute_dtype)


def styled_conv2d(
    x: torch.Tensor,
    styles: torch.Tensor,
    w: torch.Tensor,
    demodulate: bool = True,
    w_sq_sum: Optional[torch.Tensor] = None,
    input_gain: Optional[torch.Tensor] = None,
    padding: Optional[int] = None,
    up: bool = False,
    down: bool = False,
    resample_kernel: Tuple[int, ...] = DEFAULT_RESAMPLE_KERNEL,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A modulated conv from its styles on: the demodulation d (B, Cout) fp32
    from `styles` (B, Cin) and the fp32 OIHW weight `w` as it is applied (or
    from `w_sq_sum`, w's per-(out, in) sums of squares), x scaled by the
    styles times `input_gain` (a 0-d tensor, StyleGAN3's), one conv with the
    weight shared across the batch (`padding`: SAME by default). Returns
    (y, d), d not applied (None without `demodulate`)."""
    if up and down:
        raise ValueError("up and down are mutually exclusive")
    dtype = compute_dtype or x.dtype
    kh = w.shape[2]
    demod = demod_vector(styles, w, w_sq_sum) if demodulate else None  # (B, Cout)

    scale = styles if input_gain is None else styles * input_gain
    x = x * scale[:, :, None, None].to(x.dtype)
    w = w.to(dtype)
    x = x.to(dtype)
    if up:
        y = upsample_conv_2d(x, w, kernel=resample_kernel)
    elif down:
        y = conv_downsample_2d(x, w, kernel=resample_kernel)
    else:  # SAME for the odd kernels used here unless told otherwise
        y = F.conv2d(x, w, padding=kh // 2 if padding is None else padding)
    return y, demod


def dense_layer(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    gain: float = 1.0,
    lrmul: float = 1.0,
) -> torch.Tensor:
    """
    Equalized-LR dense layer: y = x @ (weight * he_std * lrmul) [+ bias * lrmul].
    `weight` is (in, out) in the unit parameterization. The bias is usually
    left to `bias_act`; pass it here only for linear layers.
    """
    coef = runtime_weight_coef(weight.shape[0], gain=gain, lrmul=lrmul)
    y = x @ (weight.to(x.dtype) * coef)
    if bias is not None:
        y = y + bias.to(y.dtype) * lrmul
    return y


def conv2d_layer(
    x: torch.Tensor,
    weight: torch.Tensor,
    up: bool = False,
    down: bool = False,
    gain: float = 1.0,
    lrmul: float = 1.0,
    resample_kernel: Tuple[int, ...] = DEFAULT_RESAMPLE_KERNEL,
) -> torch.Tensor:
    """Plain equalized-LR conv (the discriminator's layers and FromRGB): x
    (B, Cin, H, W), weight OIHW in the unit parameterization, in x's dtype."""
    if up and down:
        raise ValueError("up and down are mutually exclusive")
    _, cin, kh, kw = weight.shape
    w = weight.to(x.dtype) * runtime_weight_coef(kh * kw * cin, gain=gain, lrmul=lrmul)
    if up:
        return upsample_conv_2d(x, w, kernel=resample_kernel)
    if down:
        return conv_downsample_2d(x, w, kernel=resample_kernel)
    return F.conv2d(x, w, padding=kh // 2)  # SAME for the odd kernels used here
