"""
Plain StyleGAN3-T generator in PyTorch, fp32 with TF32 off: the reference
that the port (gance_tpu_torch/models/stylegan3.py) is held to. It follows
NVlabs/stylegan3's training/networks_stylegan3.py (MappingNetwork,
SynthesisInput, SynthesisLayer, SynthesisNetwork as `--cfg=stylegan3-t`
builds them) and the reference forms of torch_utils/ops/upfirdn2d.py and
filtered_lrelu.py, on a tree under the official state_dict names
(params["synthesis"]["L10_1044_81"]["weight"] for synthesis.L10_1044_81.weight):

- mapping: pixel norm, dense layers x @ (W * lrmul / sqrt(in)).T + b * lrmul,
  leaky ReLU 0.2 times sqrt(2); rows broadcast, w_avg.lerp(w, psi);
- input: Fourier features of the rotated and translated frequencies on
  affine_grid, damped out of band, mixed by weight / sqrt(C);
- each layer NVlabs' fused modulated conv (weights and styles pre-normalised,
  the style's mean taken over the whole batch as NVlabs does, the weight
  modulated, demodulated and scaled by rsqrt(magnitude_ema) per sample, one
  grouped conv with padding k - 1), then the filtered leaky ReLU unfused:
  bias, zero-stuff, pad, the up filter as two 1-D convolutions with gain
  up^2, leaky ReLU with gain and clamp, the down filter as two 1-D
  convolutions, every down-th sample;
- ToRGB a 1x1 modulated conv without demodulation, bias, clamp; the output
  times output_scale; uint8 as NVlabs converts (x * 127.5 + 128, truncated,
  saturated).

The filters are designed here (firwin's Kaiser-windowed sinc, in numpy). It
imports torch and numpy only, and runs in blocks of frames so that it fits
beside nothing else on the card. The configuration is a dict of NVlabs'
hyperparameters under the port's names (resolution, latent_size,
dlatent_size, num_channels, channel_base, channel_max, num_layers,
num_critical, first_cutoff, first_stopband, last_stopband_rel, margin_size,
output_scale, mapping_layers, mapping_lrmul, conv_kernel, filter_size,
lrelu_upsampling, conv_clamp, truncation_psi).
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


def firwin(numtaps: int, cutoff: float, width: float, fs: float) -> Optional[np.ndarray]:
    """scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs); None for one tap."""
    if numtaps == 1:
        return None
    atten = 2.285 * (numtaps - 1) * np.pi * (width / (fs / 2)) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    c = cutoff / (fs / 2)
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = c * np.sinc(c * m) * np.kaiser(numtaps, beta)
    return h / np.sum(h)


def layers_of(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every synthesis layer's settings, as SynthesisNetwork and
    SynthesisLayer compute them; entry 0 also carries the input's."""
    res, n = config["resolution"], config["num_layers"]
    last_cutoff = res / 2
    last_stopband = last_cutoff * config["last_stopband_rel"]
    exponents = np.minimum(np.arange(n + 1) / (n - config["num_critical"]), 1)
    cutoffs = config["first_cutoff"] * (last_cutoff / config["first_cutoff"]) ** exponents
    stopbands = config["first_stopband"] * (last_stopband / config["first_stopband"]) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + config["margin_size"] * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((config["channel_base"] / 2) / cutoffs, config["channel_max"]))
    channels[-1] = config["num_channels"]
    out = []
    for idx in range(n + 1):
        prev = max(idx - 1, 0)
        torgb = idx == n
        k = 1 if torgb else config["conv_kernel"]
        tmp = max(rates[prev], rates[idx]) * (1 if torgb else config["lrelu_upsampling"])
        up, down = int(np.rint(tmp / rates[prev])), int(np.rint(tmp / rates[idx]))
        up_taps = config["filter_size"] * up if up > 1 and not torgb else 1
        down_taps = config["filter_size"] * down if down > 1 and not torgb else 1
        pad_total = ((sizes[idx] - 1) * down + 1 - (sizes[prev] + k - 1) * up
                     + up_taps + down_taps - 2)
        pad_lo = int((pad_total + up) // 2)
        out.append({
            "name": f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}", "torgb": torgb,
            "in_channels": int(channels[prev]), "out_channels": int(channels[idx]),
            "in_size": int(sizes[prev]), "out_size": int(sizes[idx]), "kernel": k,
            "up": up, "down": down, "padding": (pad_lo, int(pad_total) - pad_lo),
            "fu": firwin(up_taps, cutoffs[prev], half_widths[prev] * 2, tmp),
            "fd": firwin(down_taps, cutoffs[idx], half_widths[idx] * 2, tmp),
            "input": {"channels": int(channels[0]), "size": int(sizes[0]),
                      "sampling_rate": float(rates[0]), "bandwidth": float(cutoffs[0])},
        })
    return out


def upfirdn2d(x: torch.Tensor, f: Optional[np.ndarray], up: int = 1, down: int = 1,
              padding: Sequence[int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """NVlabs' _upfirdn2d_ref with a separable 1-D filter f (None: identity):
    zero-stuff by `up`, pad (negative crops) by (lo, hi) on both axes,
    convolve along x then y (f times sqrt(gain) each), keep every down-th."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h, 1, w, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape(b, c, h * up, w * up)
    lo, hi = padding
    x = F.pad(x, [max(lo, 0), max(hi, 0), max(lo, 0), max(hi, 0)])
    x = x[:, :, max(-lo, 0):x.shape[2] - max(-hi, 0), max(-lo, 0):x.shape[3] - max(-hi, 0)]
    if f is None:
        x = x * gain
    else:
        taps = torch.tensor(f, dtype=torch.float32, device=x.device) * (gain ** 0.5)
        taps = taps.flip(0)[None, None].repeat(c, 1, 1)  # (C, 1, T): convolution
        x = F.conv2d(x, taps.unsqueeze(2), groups=c)
        x = F.conv2d(x, taps.unsqueeze(3), groups=c)
    return x[:, :, ::down, ::down]


def filtered_lrelu(x: torch.Tensor, fu: Optional[np.ndarray], fd: Optional[np.ndarray],
                   b: torch.Tensor, up: int, down: int, padding: Sequence[int], gain: float,
                   slope: float, clamp: float) -> torch.Tensor:
    """NVlabs' _filtered_lrelu_ref."""
    x = x + b[None, :, None, None]
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = F.leaky_relu(x, slope) * gain
    x = x.clamp(-clamp, clamp)
    return upfirdn2d(x, fd, down=down)


def dense(x: torch.Tensor, layer: Params, lrmul: float = 1.0) -> torch.Tensor:
    weight = layer["weight"]
    return x @ (weight * (lrmul / math.sqrt(weight.shape[1]))).t() + layer["bias"] * lrmul


def mapping(params: Params, z: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    lrmul = config["mapping_lrmul"]
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(config["mapping_layers"]):
        x = F.leaky_relu(dense(x, params["mapping"][f"fc{i}"], lrmul), 0.2) * SQRT2
    return x


def dlatents_from_z(params: Params, z: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    w = mapping(params, z, config)[:, None, :].repeat(1, config["num_layers"] + 2, 1)
    return params["mapping"]["w_avg"].lerp(w, config["truncation_psi"])


def fourier_input(inp: Params, w: torch.Tensor, spec: Dict[str, Any]) -> torch.Tensor:
    """SynthesisInput.forward."""
    transforms = inp["transform"][None]
    freqs, phases = inp["freqs"][None], inp["phases"][None]
    t = dense(w, inp["affine"])
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    m_r = torch.eye(3, device=w.device)[None].repeat(w.shape[0], 1, 1)
    m_r[:, 0, 0] = t[:, 0]
    m_r[:, 0, 1] = -t[:, 1]
    m_r[:, 1, 0] = t[:, 1]
    m_r[:, 1, 1] = t[:, 0]
    m_t = torch.eye(3, device=w.device)[None].repeat(w.shape[0], 1, 1)
    m_t[:, 0, 2] = -t[:, 2]
    m_t[:, 1, 2] = -t[:, 3]
    transforms = m_r @ m_t @ transforms
    phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
    freqs = freqs @ transforms[:, :2, :2]
    bw, sr, size = spec["bandwidth"], spec["sampling_rate"], spec["size"]
    amplitudes = (1 - (freqs.norm(dim=2) - bw) / (sr / 2 - bw)).clamp(0, 1)
    theta = torch.eye(2, 3, device=w.device)
    theta[0, 0] = theta[1, 1] = 0.5 * size / sr
    grids = F.affine_grid(theta[None], [1, 1, size, size], align_corners=False)
    x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
    x = x + phases.unsqueeze(1).unsqueeze(2)
    x = torch.sin(x * (np.pi * 2)) * amplitudes.unsqueeze(1).unsqueeze(2)
    x = x @ (inp["weight"] / np.sqrt(spec["channels"])).t()
    return x.permute(0, 3, 1, 2)


def modulated_conv2d(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, demodulate: bool,
                     padding: int, input_gain: torch.Tensor) -> torch.Tensor:
    """NVlabs' modulated_conv2d (the style's mean over the whole batch)."""
    batch = x.shape[0]
    _, cin, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    if demodulate:
        w = w * (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt().unsqueeze(2).unsqueeze(3).unsqueeze(4)
    w = w * input_gain
    x = x.reshape(1, -1, *x.shape[2:])
    x = F.conv2d(x, w.reshape(-1, cin, kh, kw), padding=padding, groups=batch)
    return x.reshape(batch, -1, *x.shape[2:])


def synthesis(params: Params, ws: torch.Tensor, config: Dict[str, Any]) -> torch.Tensor:
    """w+ (B, num_layers + 2, dlatent) -> float NCHW image times output_scale."""
    syn = params["synthesis"]
    specs = layers_of(config)
    x = fourier_input(syn["input"], ws[:, 0], specs[0]["input"])
    for i, spec in enumerate(specs):
        layer = syn[spec["name"]]
        styles = dense(ws[:, i + 1], layer["affine"])
        if spec["torgb"]:
            styles = styles * (1 / np.sqrt(spec["in_channels"] * spec["kernel"] ** 2))
        x = modulated_conv2d(x, layer["weight"], styles, not spec["torgb"], spec["kernel"] - 1,
                             layer["magnitude_ema"].rsqrt())
        x = filtered_lrelu(x, spec["fu"], spec["fd"], layer["bias"], spec["up"], spec["down"],
                           spec["padding"], 1.0 if spec["torgb"] else SQRT2,
                           1.0 if spec["torgb"] else 0.2, config["conv_clamp"])
    return x * config["output_scale"]


def to_uint8(images_nchw: torch.Tensor) -> torch.Tensor:
    """NCHW float in [-1, 1] -> NHWC uint8 (x * 127.5 + 128, floored, saturated)."""
    x = images_nchw.permute(0, 2, 3, 1) * 127.5 + 128.0
    return torch.clamp(torch.floor(x), 0.0, 255.0).to(torch.uint8)


@torch.no_grad()
def images_from_z(params: Params, z: torch.Tensor, config: Dict[str, Any],
                  block: int = 2) -> torch.Tensor:
    """Float NCHW images of z rows through mapping, truncation and synthesis,
    `block` frames at a time, on z's device."""
    out = []
    with exact_fp32():
        for start in range(0, z.shape[0], block):
            ws = dlatents_from_z(params, z[start:start + block].float(), config)
            out.append(synthesis(params, ws, config))
    return torch.cat(out)


@torch.no_grad()
def frames_from_z(params: Params, z: torch.Tensor, config: Dict[str, Any],
                  block: int = 2) -> torch.Tensor:
    """uint8 NHWC frames of z rows, `block` frames at a time."""
    out = []
    for start in range(0, z.shape[0], block):
        out.append(to_uint8(images_from_z(params, z[start:start + block], config, block)))
    return torch.cat(out)
