"""
Plain StyleGAN2 (config-f) generator in PyTorch, fp32 with TF32 off: the
reference that decides `correct`. It follows NVlabs/stylegan2's networks_stylegan2.py
(G_mapping, G_synthesis_stylegan2 with the skip architecture) and
dnnlib/tflib/ops/upfirdn_2d.py, on the weight tree of port_bench/harness/weights.py:

- mapping: pixel norm, then dense layers w * lrmul / sqrt(fan_in), bias * lrmul,
  leaky ReLU 0.2 times sqrt(2);
- truncation of every style row: avg + (w - avg) * psi;
- each layer a modulated conv in NVlabs' fused form (the weight modulated and
  demodulated per sample, one grouped conv), the up-conv a transposed conv
  of the flipped weight followed by the [1,3,3,1] FIR with pads (1, 1);
- noise buffer times strength, bias, leaky ReLU 0.2 times sqrt(2);
- ToRGB a 1x1 modulated conv without demodulation plus bias, added to the
  upsampled RGB of the block below (FIR upsample, pads (2, 1));
- uint8 as NVlabs converts: x * 127.5 + 128, truncated, saturated.

It imports nothing of the program, and runs in blocks of frames so that it
fits beside nothing else on the card.
"""

import math
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]
SQRT2 = math.sqrt(2.0)


@contextmanager
def exact_fp32() -> Iterator[None]:
    """TF32 off for convolutions and matmuls inside; the flags restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fir_2d(taps: Sequence[float], gain: float) -> torch.Tensor:
    k = np.asarray(taps, np.float64)
    k = np.outer(k, k)
    return torch.tensor(k / k.sum() * gain, dtype=torch.float32)


def upfirdn(x: torch.Tensor, k: torch.Tensor, up: int, pad0: int, pad1: int) -> torch.Tensor:
    """NVlabs upfirdn_2d without down: zero-insert by `up`, pad, convolve with k."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((b, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    kernel = k.flip([0, 1]).to(x.device, x.dtype)[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, kernel, groups=c)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2) * SQRT2


def mapping(params: Params, z: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    lrmul = config["mapping_lrmul"]
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(config["mapping_layers"]):
        layer = params["mapping"][f"Dense{i}"]
        weight = layer["weight"]
        x = lrelu(x @ (weight * (lrmul / math.sqrt(weight.shape[0]))) + layer["bias"] * lrmul)
    return x


def styles_of(layer: Params, w_row: torch.Tensor) -> torch.Tensor:
    mod = layer["mod_weight"]
    return w_row @ (mod / math.sqrt(mod.shape[0])) + layer["mod_bias"] + 1.0


def modulated_conv(x: torch.Tensor, w_row: torch.Tensor, layer: Params, demodulate: bool,
                   up: bool, blur: torch.Tensor) -> torch.Tensor:
    b, cin, h, w = x.shape
    weight = layer["weight"]
    cout, _, kh, kw = weight.shape
    wm = weight[None] * (1.0 / math.sqrt(cin * kh * kw)) * styles_of(layer, w_row)[:, None, :, None, None]
    if demodulate:
        wm = wm * torch.rsqrt(wm.square().sum(dim=(2, 3, 4), keepdim=True) + 1e-8)
    xg = x.reshape(1, b * cin, h, w)
    if up:
        # tf.nn.conv2d_transpose of the spatially flipped weight
        wt = wm.flip([3, 4]).transpose(1, 2).reshape(b * cin, cout, kh, kw)
        y = F.conv_transpose2d(xg, wt, stride=2, groups=b)
        y = y.reshape(b, cout, y.shape[2], y.shape[3])
        return upfirdn(y, blur, 1, 1, 1)
    y = F.conv2d(xg, wm.reshape(b * cout, cin, kh, kw), padding=kh // 2, groups=b)
    return y.reshape(b, cout, h, w)


def layer_out(x: torch.Tensor, w_row: torch.Tensor, layer: Params, noise: torch.Tensor,
              up: bool, blur: torch.Tensor) -> torch.Tensor:
    x = modulated_conv(x, w_row, layer, True, up, blur)
    x = x + noise * layer["noise_strength"]
    return lrelu(x + layer["bias"][None, :, None, None])


def torgb(x: torch.Tensor, w_row: torch.Tensor, layer: Params, blur: torch.Tensor) -> torch.Tensor:
    return modulated_conv(x, w_row, layer, False, False, blur) + layer["bias"][None, :, None, None]


def synthesis(params: Params, dlatents: torch.Tensor, config: Dict[str, Any],
              noise_planes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """w+ (B, rows, 512) -> float NCHW image. Noise: the params' constant
    buffers, or `noise_planes` (layer i's (B, 1, s, s))."""
    syn = params["synthesis"]
    blur = fir_2d(config["resample_kernel"], 4.0)
    top = int(round(math.log2(config["resolution"])))

    def noise(i: int) -> torch.Tensor:
        return syn["noise"][f"noise{i}"] if noise_planes is None else noise_planes[i]

    b = dlatents.shape[0]
    x = syn["4x4"]["Const"]["const"].expand(b, -1, -1, -1)
    x = layer_out(x, dlatents[:, 0], syn["4x4"]["Conv"], noise(0), False, blur)
    y = torgb(x, dlatents[:, 1], syn["4x4"]["ToRGB"], blur)
    for res in range(3, top + 1):
        block = syn[f"{2**res}x{2**res}"]
        x = layer_out(x, dlatents[:, res * 2 - 5], block["Conv0_up"], noise(res * 2 - 5), True, blur)
        x = layer_out(x, dlatents[:, res * 2 - 4], block["Conv1"], noise(res * 2 - 4), False, blur)
        y = upfirdn(y, blur, 2, 2, 1) + torgb(x, dlatents[:, res * 2 - 3], block["ToRGB"], blur)
    return y


def to_uint8(images_nchw: torch.Tensor) -> torch.Tensor:
    """NCHW float in [-1, 1] -> NHWC uint8 (NVlabs convert_images_to_uint8)."""
    x = images_nchw.permute(0, 2, 3, 1) * 127.5 + 128.0
    return torch.clamp(torch.floor(x), 0.0, 255.0).to(torch.uint8)


def dlatents_from_z(params: Params, z: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    rows = 2 * int(round(math.log2(config["resolution"]))) - 2
    w = mapping(params, z, config)[:, None, :].expand(-1, rows, -1)
    avg = params["dlatent_avg"]
    return avg + (w - avg) * config["truncation_psi"]


@torch.no_grad()
def frames_from_z(params: Params, z: torch.Tensor, config: Dict[str, Any],
                  block: int = 4) -> torch.Tensor:
    """uint8 NHWC frames of z rows through mapping, truncation and synthesis,
    `block` frames at a time, on z's device."""
    out = []
    with exact_fp32():
        for start in range(0, z.shape[0], block):
            dl = dlatents_from_z(params, z[start:start + block], config)
            out.append(to_uint8(synthesis(params, dl, config)))
    return torch.cat(out)
