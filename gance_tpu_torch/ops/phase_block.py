"""
Polyphase formulation of the top synthesis block (Conv0_up -> Conv1 -> ToRGB),
the counterpart of gance_tpu/ops/phase_block.py in NCHW/OIHW.

The stride-2 transposed conv and the FIR blur after it are one linear
operator. Split over the four output phases (dh, dw), each phase is a 3x3
stride-1 conv on the coarse grid, so the pair becomes one conv with 4*cout
output channels at half resolution (`fold_upconv_blur_weights`). Conv1 (3x3
SAME on the fine grid) becomes a 2x2 conv from 4*cin to 4*cout phase channels
(`fold_conv1_weights`); ToRGB (1x1) is phase-diagonal, and the phases are
interleaved back to pixels only on the small RGB tensor.

Phase/channel layout, as in JAX: channel = ph * C + c with ph = dh * 2 + dw
(row phase major). Conv1's output phases sigma use the same layout; its
sigma=1 planes hold fine row (column) 2m-1, so the conv with padding 1 emits
H/2+1 rows, valid on [0, H/2) for sigma=0 and on [1, H/2] for sigma=1. The
derivation is in the JAX module's docstring.

The Conv0_up fold and its per-phase noise/bias/lrelu epilogue are plain
PyTorch, as they are XLA in JAX (`phase_conv` is `F.conv2d`, a large product
JAX leaves to XLA). Conv1, its epilogue and ToRGB run as kernel E
(`ops/cuda/fused_ops.phase_conv1_torgb`), in the float form
(`phase_top_block`) and the fused uint8 form (`phase_top_block_uint8`) alike.
"""

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.bias_act import bias_act
from gance_tpu_torch.ops.cuda.fused_ops import (
    RGB_COLUMNS,
    fold_conv1_weights,
    phase_conv1_torgb,
)
from gance_tpu_torch.ops.modulated_conv import demod_vector, runtime_weight_coef, style_vector
from gance_tpu_torch.ops.upfirdn2d import (
    _separable_root,
    setup_filter_kernel,
    upsample2x_phases_nchw,
)

_SQRT2 = math.sqrt(2.0)


def phase_kernel_slices(k1d: np.ndarray) -> np.ndarray:
    """k1d validated for the phase path: 4 taps, symmetric."""
    k1d = np.asarray(k1d, dtype=np.float32)
    if k1d.shape != (4,) or not np.allclose(k1d, k1d[::-1]):
        raise ValueError("phase path requires a symmetric 4-tap separable FIR")
    return k1d


def resample_root(resample_kernel: Tuple[int, ...], factor: int = 2) -> np.ndarray:
    """1-D FIR root with the upsampling gain, as `upsample_conv_2d` uses it."""
    k2 = setup_filter_kernel(resample_kernel, float(factor**2))
    root = _separable_root(k2)
    if k2.shape != (4, 4) or not np.allclose(np.outer(root, root), k2):
        raise ValueError("phase path requires a separable symmetric 4x4 FIR")
    return root.astype(np.float32)


def phase_path_supported(resample_kernel: Tuple[int, ...]) -> bool:
    """Whether the polyphase top block can represent this resampling FIR
    (symmetric separable 4-tap, as config-f's (1,3,3,1))."""
    try:
        root = resample_root(resample_kernel)
    except ValueError:
        return False
    return bool(np.allclose(root, root[::-1]))


def fold_upconv_blur_weights(w: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """
    Fold the stride-2 transposed conv + 4-tap FIR into one stride-1 conv weight
    over the coarse grid.

    :param w: OIHW (cout, cin, 3, 3), already runtime-scaled (equalized LR).
    :param k1d: 1-D FIR root including the upsample gain (sums to 2).
    :return: OIHW (4*cout, cin, 3, 3), output channel = ph*cout + c.
    """
    k1d = phase_kernel_slices(k1d)
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError("phase upconv fold requires a 3x3 conv weight")
    k2 = torch.from_numpy(np.outer(k1d, k1d)).to(w.device, w.dtype)  # (4, 4)
    # G2[..., qh, qw] = sum_{dh,dw} w[..., dh, dw] * k2[qh-dh, qw-dw] -> (cout, cin, 6, 6)
    g2 = w.new_zeros((cout, cin, 6, 6))
    for dh in range(3):
        for dw in range(3):
            g2[:, :, dh:dh + 4, dw:dw + 4] += w[:, :, dh, dw, None, None] * k2
    # phase (dh, dw) kernel = G2[(1-dh)::2, (1-dw)::2]
    phases = [g2[:, :, 1 - ph_h::2, 1 - ph_w::2] for ph_h in range(2) for ph_w in range(2)]
    return torch.cat(phases, dim=0)


def _check_fine(fine: torch.Tensor) -> None:
    b, c, h, w = fine.shape
    if c != 1 or h % 2 or w % 2:
        raise ValueError(f"expected a (B, 1, even, even) fine map, got {tuple(fine.shape)}")


def phase_split_fine(fine: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) fine map -> (B, 4, H/2, W/2) phase planes
    (plane ph = dh*2+dw holds fine[2m+dh, 2n+dw] at [m, n])."""
    _check_fine(fine)
    return torch.cat([fine[:, :, dh::2, dw::2] for dh in range(2) for dw in range(2)], dim=1)


def phase_split_fine_shifted(fine: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) fine map -> (B, 4, H/2+1, W/2+1) planes in the Conv1 output
    convention: plane (sig_h, sig_w) holds fine[2m - sig_h, 2n - sig_w] at
    [m, n], zero where that lies outside the map."""
    _check_fine(fine)
    b, _, h, w = fine.shape
    out = fine.new_zeros((b, 4, h // 2 + 1, w // 2 + 1))
    for sig_h in range(2):
        for sig_w in range(2):
            # rows 2m - sig_h for m in [sig_h, sig_h + h/2): fine rows sig_h, sig_h+2, ...
            out[:, sig_h * 2 + sig_w, sig_h:sig_h + h // 2, sig_w:sig_w + w // 2] = (
                fine[:, 0, (2 - sig_h) % 2::2, (2 - sig_w) % 2::2]
            )
    return out


def phase_conv(x: torch.Tensor, folded_w: torch.Tensor, padding: int,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """The conv of the folded weights: stride 1, NCHW/OIHW, in `compute_dtype`."""
    return F.conv2d(x.to(compute_dtype), folded_w.to(compute_dtype), padding=padding)


def interleave_phases_nchw(rgb_ph: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """
    (B, 4*C, H/2+1, W/2+1) Conv1-convention phase planes (channel = ph*C + k)
    -> (B, C, H, W) fine image: fine row 2j is sigma=0 row j, fine row 2j+1 is
    sigma=1 row j+1; the same for columns.
    """
    b = rgb_ph.shape[0]
    c = rgb_ph.shape[1] // 4
    hh, hw = h // 2, w // 2
    r = rgb_ph.reshape(b, 2, 2, c, hh + 1, hw + 1)  # (B, sig_h, sig_w, C, m, n)
    rows = torch.stack([r[:, 0, :, :, 0:hh], r[:, 1, :, :, 1:hh + 1]], dim=4)
    rows = rows.reshape(b, 2, c, h, hw + 1)  # (B, sig_w, C, H, n)
    cols = torch.stack([rows[:, 0, ..., 0:hw], rows[:, 1, ..., 1:hw + 1]], dim=4)
    return cols.reshape(b, c, h, w)


def interleave_phases_nhwc(x_ph: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """
    The upconv-convention interleave (JAX's name; the port's tensors are
    NCHW): (B, 4*C, H/2, W/2) phase planes, plane ph = dh*2+dw holding fine
    pixel (2m+dh, 2n+dw) -> (B, C, H, W).
    """
    b, c4, hh, hw = x_ph.shape
    c = c4 // 4
    x = x_ph.reshape(b, 2, 2, c, hh, hw).permute(0, 3, 4, 1, 5, 2)  # (B, C, m, dh, n, dw)
    return x.reshape(b, c, h, w)


def _tile4(vec: torch.Tensor) -> torch.Tensor:
    """Per-channel vector (.., C) -> (.., 4*C) in the ph-major layout."""
    return vec.repeat(*([1] * (vec.ndim - 1)), 4)


def _add_phase_noise(x_ph: torch.Tensor, noise_ph: Optional[torch.Tensor],
                     strength: torch.Tensor) -> torch.Tensor:
    """x_ph (B, 4*C, h, w) + noise_ph (1 or B, 4, h, w) * strength, broadcast over C."""
    if noise_ph is None:
        return x_ph
    b, c4, hh, hw = x_ph.shape
    x5 = x_ph.reshape(b, 4, c4 // 4, hh, hw)
    x5 = x5 + noise_ph[:, :, None].to(x_ph.dtype) * strength.to(x_ph.dtype)
    return x5.reshape(b, c4, hh, hw)


def phase_upconv(
    x: torch.Tensor,
    up: Dict,
    dl_up: torch.Tensor,
    noise_up_fine: Optional[torch.Tensor],
    resample_kernel: Tuple[int, ...],
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Conv0_up + FIR blur as one folded phase conv with its per-phase
    demod/noise/bias/lrelu: (B, cin, H/2, W/2) -> (B, 4*cout, H/2, W/2),
    channel = ph*cout + c."""
    cout, cin, kh, kw = up["weight"].shape
    w_up = up["weight"].float() * runtime_weight_coef(kh * kw * cin)
    s_up = style_vector(dl_up, up["mod_weight"], up["mod_bias"])  # (B, cin)
    d_up = demod_vector(s_up, w_up)  # (B, cout)
    folded_up = fold_upconv_blur_weights(w_up, resample_root(resample_kernel))
    xs = (x * s_up[:, :, None, None].to(x.dtype)).to(compute_dtype)
    xp = phase_conv(xs, folded_up, 1, compute_dtype)
    xp = xp * _tile4(d_up).to(xp.dtype)[:, :, None, None]
    noise_up_ph = None if noise_up_fine is None else phase_split_fine(noise_up_fine)
    xp = _add_phase_noise(xp, noise_up_ph, up["noise_strength"])
    return bias_act(xp, _tile4(up["bias"]), act="lrelu")


# (x, dl_up, noise_up_fine) -> `phase_upconv`'s output, in place of it
UpConv = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def _phase_pre_rgb(
    x: torch.Tensor,
    block: Dict,
    dlatent_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    noise_up_fine: Optional[torch.Tensor],
    noise_c1_fine: Optional[torch.Tensor],
    resample_kernel: Tuple[int, ...],
    compute_dtype: torch.dtype,
    upconv: Optional[UpConv] = None,
) -> Dict[str, torch.Tensor]:
    """
    The phase top block up to kernel E: Conv0_up + blur as one folded conv with
    its per-phase demod/noise/bias/lrelu (`phase_upconv` of block["Conv0_up"],
    or `upconv(x, dl_up, noise_up_fine)` where given, as the synthesis
    forward runs each layer through its runner), then E's operands for Conv1
    and ToRGB. Returns the keyword arguments of `phase_conv1_torgb`: x (B, 4C,
    H/2, W/2) scaled by Conv1's style, w4 the folded Conv1 (4C, 4C, 2, 2),
    demod (B, 4C), noise_bias (1 or B, 4C, H/2+1, W/2+1) in fp32, and wrgb
    (B, 4C, 16) with sqrt(2) * s_rgb folded into the phase-diagonal ToRGB.
    """
    c1, torgb = block["Conv1"], block["ToRGB"]
    dl_up, dl_c1, dl_rgb = dlatent_rows
    if upconv is None:
        xp = phase_upconv(x, block["Conv0_up"], dl_up, noise_up_fine, resample_kernel,
                          compute_dtype)
    else:
        xp = upconv(x, dl_up, noise_up_fine)
    cout = xp.shape[1] // 4

    # Phase folding assumes the StyleGAN2 top-block shape chain: Conv1 is 3x3
    # with cin == cout == Conv0_up's cout, and ToRGB consumes that count.
    if tuple(c1["weight"].shape) != (cout, cout, 3, 3):
        raise ValueError(f"phase_top_block: Conv1 weight {tuple(c1['weight'].shape)} breaks "
                         f"the ({cout}, {cout}, 3, 3) top-block invariant")
    n_rgb = torgb["weight"].shape[0]
    if torgb["weight"].shape[1] != cout:
        raise ValueError(f"phase_top_block: ToRGB cin {torgb['weight'].shape[1]} != Conv1 "
                         f"cout {cout}")
    if 4 * n_rgb > RGB_COLUMNS:
        raise ValueError(f"phase_top_block: {n_rgb} output channels; kernel E takes at most "
                         f"{RGB_COLUMNS // 4}")

    # --- Conv1 as a 2x2 phase conv (sigma-shift convention): E's operands ---
    v = c1["weight"].float() * runtime_weight_coef(9 * cout)
    s_c1 = style_vector(dl_c1, c1["mod_weight"], c1["mod_bias"])  # (B, cout)
    d_c1 = demod_vector(s_c1, v)
    xp = xp * _tile4(s_c1).to(xp.dtype)[:, :, None, None]
    hh, hw = xp.shape[2], xp.shape[3]
    bias = c1["bias"].float()[None, None, :, None, None]  # over (Bn, 4, C, h, w)
    if noise_c1_fine is None:
        noise_bias = bias.expand(1, 4, cout, hh + 1, hw + 1)
    else:
        noise_ph = phase_split_fine_shifted(noise_c1_fine).float()
        noise_bias = noise_ph[:, :, None] * c1["noise_strength"].float() + bias
    noise_bias = noise_bias.reshape(-1, 4 * cout, hh + 1, hw + 1)

    # --- ToRGB: phase-diagonal (4C, 16), sqrt(2) of the lrelu and s_rgb folded in ---
    wr = torgb["weight"].float()[:, :, 0, 0].t() * runtime_weight_coef(cout)  # (cout, n_rgb)
    s_rgb = style_vector(dl_rgb, torgb["mod_weight"], torgb["mod_bias"])  # (B, cout)
    wrgb = wr.new_zeros((x.shape[0], 4 * cout, RGB_COLUMNS))
    for ph in range(4):
        wrgb[:, ph * cout:(ph + 1) * cout, ph * n_rgb:(ph + 1) * n_rgb] = (
            (_SQRT2 * s_rgb)[:, :, None] * wr
        )
    return dict(x=xp, w4=fold_conv1_weights(v), demod=_tile4(d_c1), noise_bias=noise_bias,
                wrgb=wrgb)


def _phase_rgb_planes(
    x: torch.Tensor,
    block: Dict,
    dlatent_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    noise_up_fine: Optional[torch.Tensor],
    noise_c1_fine: Optional[torch.Tensor],
    resample_kernel: Tuple[int, ...],
    compute_dtype: torch.dtype,
    upconv: Optional[UpConv] = None,
) -> torch.Tensor:
    """`_phase_pre_rgb` plus kernel E: the RGB phase planes (B, 4*n_rgb, H/2+1,
    W/2+1), channel = ph*n_rgb + k, ph = sigma_h*2 + sigma_w."""
    operands = _phase_pre_rgb(x, block, dlatent_rows, noise_up_fine, noise_c1_fine,
                              resample_kernel, compute_dtype, upconv)
    n_rgb = block["ToRGB"]["weight"].shape[0]
    return phase_conv1_torgb(**operands)[:, :4 * n_rgb]


def phase_top_block(
    x: torch.Tensor,
    block: Dict,
    dlatent_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    noise_up_fine: Optional[torch.Tensor],
    noise_c1_fine: Optional[torch.Tensor],
    y_up: Optional[torch.Tensor],
    resample_kernel: Tuple[int, ...],
    compute_dtype: torch.dtype,
    upconv: Optional[UpConv] = None,
) -> torch.Tensor:
    """
    The full top synthesis block (Conv0_up -> Conv1 -> ToRGB + skip add) in
    phase space; the standard `_synthesis_layer` / `_torgb` chain's values up
    to fp reassociation.

    :param x: previous block output (B, cin, H/2, W/2).
    :param block: params with "Conv0_up", "Conv1", "ToRGB".
    :param dlatent_rows: the three per-layer dlatent rows (B, w_dim).
    :param noise_up_fine, noise_c1_fine: fine-grid noise (1 or B, 1, H, W) of
        the two conv layers, or None.
    :param y_up: the upsampled RGB accumulator (B, n_rgb, H, W), or None.
    :param upconv: replaces `phase_upconv` (see `_phase_pre_rgb`).
    :return: the new RGB accumulator (B, n_rgb, H, W).
    """
    h, w = x.shape[2] * 2, x.shape[3] * 2
    t_ph = _phase_rgb_planes(x, block, dlatent_rows, noise_up_fine, noise_c1_fine,
                             resample_kernel, compute_dtype, upconv)
    t = interleave_phases_nchw(t_ph, h, w)
    t = t + block["ToRGB"]["bias"].to(t.dtype)[None, :, None, None]
    return t if y_up is None else y_up + t


def phase_top_block_uint8(
    x: torch.Tensor,
    block: Dict,
    dlatent_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    noise_up_fine: Optional[torch.Tensor],
    noise_c1_fine: Optional[torch.Tensor],
    y: Optional[torch.Tensor],
    resample_kernel: Tuple[int, ...],
    compute_dtype: torch.dtype,
    drange: Tuple[float, float] = (-1.0, 1.0),
    upconv: Optional[UpConv] = None,
) -> torch.Tensor:
    """
    The phase top block with the uint8 output fused in: the skip upsample stays
    in phase form (`upsample2x_phases_nchw`, no full-size float image), the
    skip add, ToRGB bias and quantisation run per phase, and only uint8 bytes
    are interleaved. The same adds on the same operands in the same order as
    `images_to_uint8(phase_top_block(...))`, so the two agree bit for bit.

    :param y: the RGB accumulator BEFORE the upsample (B, n_rgb, H/2, W/2), or None.
    :return: uint8 NHWC image (B, H, W, n_rgb).
    """
    b, _, hh, hw = x.shape
    n_rgb = block["ToRGB"]["weight"].shape[0]
    bias = block["ToRGB"]["bias"]
    t_ph = _phase_rgb_planes(x, block, dlatent_rows, noise_up_fine, noise_c1_fine,
                             resample_kernel, compute_dtype, upconv)
    y_phases = None
    if y is not None:
        root = tuple(float(v) for v in resample_root(resample_kernel))
        y_phases = upsample2x_phases_nchw(y, root)
    lo, hi = drange
    scale = 255.0 / (hi - lo)
    offset = 0.5 - lo * scale
    quantized = []
    for ph in range(4):
        sig_h, sig_w = ph // 2, ph % 2
        t = t_ph[:, ph * n_rgb:(ph + 1) * n_rgb, sig_h:hh + sig_h, sig_w:hw + sig_w]
        t = t + bias.to(t.dtype)[None, :, None, None]
        if y_phases is not None:
            t = y_phases[ph].to(t.dtype) + t  # the operand order of the fine `y + t`
        v = t.float() * scale + offset
        quantized.append(torch.clamp(torch.floor(v), 0.0, 255.0).to(torch.uint8))
    # (sig_h, sig_w, B, C, m, n) -> (B, m, sig_h, n, sig_w, C) = (B, H, W, C)
    q = torch.stack(quantized).reshape(2, 2, b, n_rgb, hh, hw)
    return q.permute(2, 4, 0, 5, 1, 3).reshape(b, 2 * hh, 2 * hw, n_rgb)
