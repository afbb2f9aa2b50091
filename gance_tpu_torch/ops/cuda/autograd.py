"""
Gradients through kernels A-E: one `torch.autograd.Function` per kernel.

The public wrappers in `fused_ops.py` go through these Functions on both
devices wherever a gradient may be asked for (grad enabled and an input that
requires it); otherwise they call the forward's `_*_run` directly. A
Function's forward runs the kernel on a CUDA tensor and its plain twin on a
CPU tensor; its backward is built only from differentiable calls,
so a double backward (R1 through the discriminator, path length through
synthesis) works and, on the card, launches the kernels again:

  * D (a 4x4 correlation with pads (p0, p1)): the input gradient is D again,
    with the taps flipped and pads (3-p0, 3-p1); every order is D.
  * C (the separable pad-1 blur): the input gradient is D with the flipped
    outer product of C's taps over the output gradient padded (2, 2);
    columns at or past `w_logical` get zero gradient.
  * B (the 2x polyphase upsample): the input gradient is B's adjoint, a
    stride-2 4-tap FIR per axis, in plain PyTorch (`upsample2x_blur_adjoint`;
    the JAX package has no kernel for it, its training path running none).
  * A (noise + bias + lrelu * sqrt(2)): gradients for x, noise, bias and
    strength from the saved output y alone (lrelu * sqrt(2) keeps the sign,
    so the slope is sqrt(2) where y >= 0 and 0.2 * sqrt(2) elsewhere).
  * E (the phase top block's Conv1 + epilogue + ToRGB): the backward
    recomputes the pre-activation from the nine taps on the fine grid
    (cuDNN on the card) for the lrelu slope, then takes the conv's input and
    weight gradients in one `convolution_backward`; no kernel, as in the JAX
    package, which differentiates its XLA phase path.

Output gradients may arrive non-contiguous (a `permute` downstream); they are
made contiguous before a kernel launch.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from gance_tpu_torch.ops.cuda import fused_ops as K
from gance_tpu_torch.ops.precision import exact_fp32

_SQRT2 = 2.0 ** 0.5


def _flipped(taps: Tuple[float, ...]) -> Tuple[float, ...]:
    """A row-major 4x4 FIR flipped on both axes."""
    return tuple(reversed(taps))


def upsample2x_blur_adjoint(g: torch.Tensor, taps: Tuple[float, ...]) -> torch.Tensor:
    """
    The adjoint of B, (B, C, 2H, 2W) -> (B, C, H, W) in g's dtype, summed in
    fp32: per axis gx[m] = k3*g[2m-1] + k2*g[2m] + k1*g[2m+1] + k0*g[2m+2],
    a stride-2 4-tap FIR over g padded by one zero on each side.
    """
    k0, k1, k2, k3 = taps

    def along_last(t: torch.Tensor) -> torch.Tensor:
        tp = F.pad(t, (1, 1))
        return k3 * tp[..., 0:-2:2] + k2 * tp[..., 1:-1:2] + k1 * tp[..., 2::2] + k0 * tp[..., 3::2]

    gw = along_last(g.float())
    return along_last(gw.transpose(2, 3)).transpose(2, 3).to(g.dtype)


class FusedBiasNoiseLrelu(torch.autograd.Function):
    """Kernel A: y = lrelu(x + noise * strength + bias, 0.2) * sqrt(2)."""

    @staticmethod
    def forward(ctx, x, noise, bias, strength):  # pylint: disable=arguments-differ
        y = K._fused_bias_noise_lrelu_run(x, noise, bias, strength)
        ctx.save_for_backward(y, noise, strength)
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        y, noise, strength = ctx.saved_tensors
        gs = g.float() * _SQRT2
        gpre = torch.where(y >= 0, gs, gs * 0.2)
        gx = gpre.to(ctx.x_dtype) if ctx.needs_input_grad[0] else None
        gnoise = gbias = gstrength = None
        if ctx.needs_input_grad[1]:
            gnoise = (gpre * strength).sum(dim=1, keepdim=True)
            if noise.shape[0] == 1:
                gnoise = gnoise.sum(dim=0, keepdim=True)
        if ctx.needs_input_grad[2]:
            gbias = gpre.sum(dim=(0, 2, 3))
        if ctx.needs_input_grad[3]:
            gstrength = (gpre * noise).sum().reshape(strength.shape)
        return gx, gnoise, gbias, gstrength


class Upsample2xBlur(torch.autograd.Function):
    """Kernel B: the 2x polyphase upsample with taps (k0, k1, k2, k3)."""

    @staticmethod
    def forward(ctx, x, taps):  # pylint: disable=arguments-differ
        ctx.taps = taps
        return K._upsample2x_blur_run(x, taps)

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        return upsample2x_blur_adjoint(g, ctx.taps), None


class Blur4SeparablePad11(torch.autograd.Function):
    """Kernel C: the separable 4-tap blur with pad 1 on x[..., :w_logical]."""

    @staticmethod
    def forward(ctx, x, taps, w_logical):  # pylint: disable=arguments-differ
        ctx.taps, ctx.w_logical, ctx.width = taps, w_logical, x.shape[3]
        return K._blur4_separable_pad11_run(x, taps, w_logical)

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        gx = blur4_separable_pad11_input_grad(g, ctx.taps)
        if ctx.width > ctx.w_logical:
            gx = F.pad(gx, (0, ctx.width - ctx.w_logical))
        return gx, None, None


def blur4_separable_pad11_input_grad(g: torch.Tensor, taps: Tuple[float, ...]) -> torch.Tensor:
    """C's input gradient, (B, C, H-1, W-1) -> (B, C, H, W): D with the flipped
    outer product of C's taps over g padded (2, 2)."""
    outer = tuple(a * b for a in taps for b in taps)
    return K.stencil_blur4_valid(g.contiguous(), _flipped(outer), (2, 2))


class StencilBlur4Valid(torch.autograd.Function):
    """Kernel D: a 4x4 correlation over x padded by (p0, p1)."""

    @staticmethod
    def forward(ctx, x, taps, pads):  # pylint: disable=arguments-differ
        ctx.taps, ctx.pads = taps, pads
        return K._stencil_blur4_valid_run(x, taps, pads)

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        p0, p1 = ctx.pads
        gx = K.stencil_blur4_valid(g.contiguous(), _flipped(ctx.taps), (3 - p0, 3 - p1))
        return gx, None, None


def _unfold_adjoint(gv: torch.Tensor, c4_out: int) -> torch.Tensor:
    """The adjoint of `unfold_conv1_weights`: the taps' gradient (C, C, 3, 3)
    written into output phase 0's tap blocks of a zero (4C, 4C, 2, 2)."""
    cout, cin = gv.shape[:2]
    grid = F.pad(gv, (1, 0, 1, 0)).reshape(cout, cin, 2, 2, 2, 2)  # (o, c, kh, dh, kw, dw)
    block = grid.permute(0, 3, 5, 1, 2, 4).reshape(cout, 4 * cin, 2, 2)
    return F.pad(block, (0, 0, 0, 0, 0, 0, 0, c4_out - cout))


class PhaseConv1Torgb(torch.autograd.Function):
    """
    Kernel E: rgb = lrelu(conv2d(x, w4, pad 1) * demod + noise_bias) @ wrgb
    over the phase planes, z rounded to x's dtype before the ToRGB product.

    E reads only the nine taps of the fold w4 (`unfold_conv1_weights`, output
    phase 0's copy), so w4's gradient is the taps' gradient written back
    there: the derivative of what E computes. Through `fold_conv1_weights`
    it gives the 3x3 weight the same gradient as the dense twin does.
    """

    @staticmethod
    def forward(ctx, x, w4, demod, noise_bias, wrgb):  # pylint: disable=arguments-differ
        ctx.save_for_backward(x, w4, demod, noise_bias, wrgb)
        return K._phase_conv1_torgb_run(x, w4, demod, noise_bias, wrgb)

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        x, w4, demod, noise_bias, wrgb = ctx.saved_tensors
        need_x, need_w4, need_demod, need_nb, need_rgb = ctx.needs_input_grad
        dtype = x.dtype
        v = K.unfold_conv1_weights(w4).to(dtype).float()
        fine = K.phases_to_fine(x).float()
        with exact_fp32():
            acc = K._conv_phases_of_fine(F.conv2d(fine, v, padding=2))
            pre = acc * demod.float()[:, :, None, None] + noise_bias.to(dtype).float()
            gf = g.float()
            gz = torch.einsum("bkhw,bck->bchw", gf, wrgb.to(dtype).float())
            gpre = torch.where(pre >= 0, gz, gz * 0.2)
            gwrgb = gdemod = gnb = gx = gw4 = None
            if need_rgb:
                z = torch.maximum(pre, pre * 0.2).to(dtype).float()
                gwrgb = torch.einsum("bchw,bkhw->bck", z, gf).to(wrgb.dtype)
            if need_demod:
                gdemod = (gpre * acc).sum(dim=(2, 3)).to(demod.dtype)
            if need_nb:
                gnb = gpre if noise_bias.shape[0] == gpre.shape[0] else gpre.sum(0, keepdim=True)
                gnb = gnb.to(noise_bias.dtype)
            if need_x or need_w4:
                gacc = K._fine_of_conv_phases(gpre * demod.float()[:, :, None, None])
                gfine, gv, _ = torch.ops.aten.convolution_backward(
                    gacc, fine, v, None, (1, 1), (2, 2), (1, 1), False, (0, 0), 1,
                    (need_x, need_w4, False))
                if need_x:
                    gx = K.fine_to_phases(gfine).to(dtype)
                if need_w4:
                    gw4 = _unfold_adjoint(gv, w4.shape[0]).to(w4.dtype)
        return gx, gw4, gdemod, gnb, gwrgb
