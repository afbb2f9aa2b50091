"""
StyleGAN3-T ("Alias-Free Generative Adversarial Networks", Karras et al.,
2021) in PyTorch: the generator of NVlabs/stylegan3's
`training/networks_stylegan3.py` as `train.py --cfg=stylegan3-t` builds it,
for inference in fp32.

  * mapping: pixel norm, `mapping_layers` dense layers (weight [out, in] times
    lrmul / sqrt(in), bias times lrmul, leaky ReLU 0.2 times sqrt(2)), the
    row broadcast to `num_layers + 2` style rows, truncation w_avg.lerp(w, psi);
  * input: Fourier features sin(2 pi (f . x + phi)) on a grid of the first
    layer's size, the frequencies rotated and translated per sample by an
    affine of w[0], damped out of band, then mixed by weight / sqrt(C);
  * layers L0-L13: a modulated 3x3 conv with full padding (k - 1) on grids
    with a margin, weights and styles pre-normalised before the demodulation,
    the input gain rsqrt(magnitude_ema), then the filtered leaky ReLU
    (`ops/filtered_lrelu.py`, kernel F on the card) at the layer's up and
    down factors with its Kaiser-windowed low-pass filters;
  * L14, ToRGB: a modulated 1x1 conv without demodulation (styles times
    1 / sqrt(Cin)), bias, clamp; then the output times `output_scale` and
    uint8 as `models/stylegan2.py::images_to_uint8` makes it.

The geometry (cutoffs, stopbands, sampling rates, sizes, channels, filters,
pads) follows `SynthesisNetwork.__init__` and `SynthesisLayer.__init__` and is
derived from the config alone (`synthesis_geometry`). The params tree holds
every learned parameter and every random buffer under the official
`state_dict` names, nested at the dots (`synthesis.L10_1044_81.weight` is
params["synthesis"]["L10_1044_81"]["weight"]); the filters are not stored.
What is constant per network (the normalised conv weights, their sums of
squares, the input gains, the Fourier grid) is made once by `prepare`, which
`synthesis/runtime.py::SynthesisNetwork` calls at load.

One departure from NVlabs: the styles are normalised per row
(s * rsqrt(mean(s^2)) over each sample's channels), where NVlabs takes the
mean over the whole batch. The scalar cancels in the demodulation except for
its 1e-8, so the two agree to fp32 rounding, and a frame does not depend on
the rows it is batched with (the runtime pads remainders).
"""

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.models.stylegan2 import (
    DEFAULT_TRUNCATION_PSI,
    broadcast_dlatents,
    images_to_uint8,
    truncate_dlatents,
)
from gance_tpu_torch.ops.bias_act import bias_act
from gance_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from gance_tpu_torch.ops.modulated_conv import dense_layer, styled_conv2d
from gance_tpu_torch.ops.precision import apply_conv_precision, exact_fp32
from gance_tpu_torch.utils.profiling import span

Params = Dict[str, Any]


@dataclass(frozen=True)
class StyleGAN3Config:
    """StyleGAN3-T's hyperparameters (NVlabs' defaults; FFHQ 1024px)."""

    resolution: int = 1024
    latent_size: int = 512
    dlatent_size: int = 512
    num_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_layers: int = 14
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2 ** 2.1
    last_stopband_rel: float = 2 ** 0.3
    margin_size: int = 10
    output_scale: float = 0.25
    mapping_layers: int = 2
    mapping_lrmul: float = 0.01
    conv_kernel: int = 3
    filter_size: int = 6
    lrelu_upsampling: int = 2
    conv_clamp: float = 256.0

    @property
    def num_style_rows(self) -> int:
        """16 at the defaults: the input's row and one per layer."""
        return self.num_layers + 2


@dataclass(frozen=True)
class InputGeometry:
    channels: int
    size: int
    sampling_rate: float
    bandwidth: float


@dataclass(frozen=True)
class LayerGeometry:
    """One SynthesisLayer as NVlabs' constructor sets it up."""

    name: str
    is_torgb: bool
    in_channels: int
    out_channels: int
    in_size: int
    out_size: int
    in_sampling_rate: int
    out_sampling_rate: int
    in_cutoff: float
    out_cutoff: float
    in_half_width: float
    out_half_width: float
    kernel: int
    up: int
    down: int
    up_taps: int
    down_taps: int
    padding: Tuple[int, int]
    gain: float
    slope: float
    clamp: float
    up_filter: Optional[Tuple[float, ...]]
    down_filter: Optional[Tuple[float, ...]]


def kaiser_beta(atten: float) -> float:
    """The Kaiser window's beta for a stopband attenuation in dB (scipy's
    `kaiser_beta`)."""
    if atten > 50:
        return 0.1102 * (atten - 8.7)
    if atten > 21:
        return 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    return 0.0


def design_lowpass_filter(numtaps: int, cutoff: float, width: float,
                          fs: float) -> Optional[np.ndarray]:
    """`scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)` in numpy
    (float64): a Kaiser-windowed sinc, normalised to unit DC gain. None for
    one tap (the identity)."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    c = cutoff / nyq
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = c * np.sinc(c * m) * np.kaiser(numtaps, kaiser_beta(atten))
    return h / h.sum()


@lru_cache(maxsize=16)
def synthesis_geometry(config: StyleGAN3Config) -> Tuple[InputGeometry, Tuple[LayerGeometry, ...]]:
    """The input's and every layer's geometry (NVlabs `SynthesisNetwork`)."""
    res = config.resolution
    last_cutoff = res / 2
    last_stopband = last_cutoff * config.last_stopband_rel
    exponents = np.minimum(np.arange(config.num_layers + 1)
                           / (config.num_layers - config.num_critical), 1)
    cutoffs = config.first_cutoff * (last_cutoff / config.first_cutoff) ** exponents
    stopbands = config.first_stopband * (last_stopband / config.first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + config.margin_size * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((config.channel_base / 2) / cutoffs, config.channel_max))
    channels[-1] = config.num_channels

    inp = InputGeometry(int(channels[0]), int(sizes[0]), float(rates[0]), float(cutoffs[0]))
    layers: List[LayerGeometry] = []
    for idx in range(config.num_layers + 1):
        prev = max(idx - 1, 0)
        torgb = idx == config.num_layers
        kernel = 1 if torgb else config.conv_kernel
        in_rate, out_rate = int(rates[prev]), int(rates[idx])
        tmp_rate = max(in_rate, out_rate) * (1 if torgb else config.lrelu_upsampling)
        up, down = int(np.rint(tmp_rate / in_rate)), int(np.rint(tmp_rate / out_rate))
        up_taps = config.filter_size * up if up > 1 and not torgb else 1
        down_taps = config.filter_size * down if down > 1 and not torgb else 1
        up_filter = design_lowpass_filter(up_taps, cutoffs[prev], half_widths[prev] * 2, tmp_rate)
        down_filter = design_lowpass_filter(down_taps, cutoffs[idx], half_widths[idx] * 2,
                                            tmp_rate)
        in_size, out_size = int(sizes[prev]), int(sizes[idx])
        pad_total = (out_size - 1) * down + 1 - (in_size + kernel - 1) * up + up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        layers.append(LayerGeometry(
            name=f"L{idx}_{out_size}_{int(channels[idx])}", is_torgb=torgb,
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=in_size, out_size=out_size, in_sampling_rate=in_rate,
            out_sampling_rate=out_rate, in_cutoff=float(cutoffs[prev]),
            out_cutoff=float(cutoffs[idx]), in_half_width=float(half_widths[prev]),
            out_half_width=float(half_widths[idx]), kernel=kernel, up=up, down=down,
            up_taps=up_taps, down_taps=down_taps, padding=(pad_lo, pad_total - pad_lo),
            gain=1.0 if torgb else math.sqrt(2), slope=1.0 if torgb else 0.2,
            clamp=config.conv_clamp,
            up_filter=None if up_filter is None else tuple(float(v) for v in up_filter),
            down_filter=None if down_filter is None else tuple(float(v) for v in down_filter),
        ))
    return inp, tuple(layers)


def init_generator_params(seed: int, config: StyleGAN3Config) -> Params:
    """A fresh network as NVlabs' constructors initialise it, as numpy float32:
    weights N(0, 1) (mapping / lrmul), biases 0 (the affines' 1), the input's
    affine 0 with bias (1, 0, 0, 0), frequencies in the input's band,
    phases uniform in [-0.5, 0.5), magnitude_ema 1, w_avg 0."""
    rng = np.random.RandomState(seed)
    inp, layers = synthesis_geometry(config)
    f32 = np.float32

    def normal(*shape: int) -> np.ndarray:
        return rng.standard_normal(shape).astype(f32)

    mapping: Params = {}
    fan_in = config.latent_size
    for i in range(config.mapping_layers):
        mapping[f"fc{i}"] = {"weight": normal(config.dlatent_size, fan_in) / f32(config.mapping_lrmul),
                             "bias": np.zeros((config.dlatent_size,), f32)}
        fan_in = config.dlatent_size
    mapping["w_avg"] = np.zeros((config.dlatent_size,), f32)

    freqs = rng.standard_normal((inp.channels, 2))
    radii = np.sqrt(np.square(freqs).sum(axis=1, keepdims=True))
    freqs = freqs / (radii * np.exp(np.square(radii)) ** 0.25) * inp.bandwidth
    synthesis: Params = {"input": {
        "weight": normal(inp.channels, inp.channels),
        "affine": {"weight": np.zeros((4, config.dlatent_size), f32),
                   "bias": np.array([1, 0, 0, 0], f32)},
        "transform": np.eye(3, dtype=f32),
        "freqs": freqs.astype(f32),
        "phases": (rng.uniform(size=inp.channels) - 0.5).astype(f32),
    }}
    for geo in layers:
        synthesis[geo.name] = {
            "weight": normal(geo.out_channels, geo.in_channels, geo.kernel, geo.kernel),
            "bias": np.zeros((geo.out_channels,), f32),
            "magnitude_ema": np.ones((), f32),
            "affine": {"weight": normal(geo.in_channels, config.dlatent_size),
                       "bias": np.ones((geo.in_channels,), f32)},
        }
    return {"mapping": mapping, "synthesis": synthesis}


@dataclass
class PreparedGenerator:
    """A params tree on one device with what is constant per network made
    once: each conv layer's normalised weight and its sums of squares, each
    layer's input gain, the input's grid and mixing matrix."""

    config: StyleGAN3Config
    params: Params
    grid: torch.Tensor  # (1, size, size, 2): the input's sampling grid
    mix: torch.Tensor  # (C, C): the input's (weight / sqrt(C)).T
    layers: List[Dict[str, Any]]


def prepare(params: Params, config: StyleGAN3Config) -> PreparedGenerator:
    """`params` (tensors on one device) made ready for forwards, once a network."""
    inp, geometry = synthesis_geometry(config)
    synthesis = params["synthesis"]
    device = synthesis["input"]["weight"].device
    theta = torch.eye(2, 3)
    theta[0, 0] = theta[1, 1] = 0.5 * inp.size / inp.sampling_rate
    grid = F.affine_grid(theta[None], [1, 1, inp.size, inp.size], align_corners=False)
    mix = (synthesis["input"]["weight"].float() / math.sqrt(inp.channels)).t().contiguous()
    layers = []
    for geo in geometry:
        layer = synthesis[geo.name]
        weight = layer["weight"].float()
        if not geo.is_torgb:
            weight = weight * weight.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        layers.append({
            "geometry": geo, "weight": weight.contiguous(),
            "w_sq_sum": None if geo.is_torgb else weight.square().sum(dim=(2, 3)),
            "input_gain": layer["magnitude_ema"].float().rsqrt(),
            "affine": layer["affine"], "bias": layer["bias"].float(),
        })
    return PreparedGenerator(config=config, params=params, grid=grid.to(device), mix=mix,
                             layers=layers)


def as_prepared(params: Any, config: StyleGAN3Config) -> PreparedGenerator:
    return params if isinstance(params, PreparedGenerator) else prepare(params, config)


def _affine(w: torch.Tensor, affine: Params) -> torch.Tensor:
    """An FC layer of lrmul 1 on a style row: w @ (W / sqrt(in)).T + b, fp32."""
    weight = affine["weight"].float()
    with exact_fp32():
        out = w.float() @ (weight * (1.0 / math.sqrt(weight.shape[1]))).t()
    return out + affine["bias"].float()


def mapping_apply(params: Params, z: torch.Tensor, config: StyleGAN3Config) -> torch.Tensor:
    """z (B, latent) -> w (B, dlatent): pixel norm, then the dense + leaky
    ReLU layers (the official [out, in] weights through the port's
    `dense_layer`, which takes [in, out])."""
    apply_conv_precision()
    mapping = params["mapping"]
    lrmul = config.mapping_lrmul
    x = z.float()
    x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(config.mapping_layers):
        fc = mapping[f"fc{i}"]
        x = bias_act(dense_layer(x, fc["weight"].t(), lrmul=lrmul), fc["bias"] * lrmul,
                     act="lrelu")
    return x


def synthesis_input(prepared: PreparedGenerator, w0: torch.Tensor) -> torch.Tensor:
    """The Fourier features of style row w0 (B, dlatent): (B, C, size, size)."""
    inp_geo, _ = synthesis_geometry(prepared.config)
    inp = prepared.params["synthesis"]["input"]
    batch = w0.shape[0]
    t = _affine(w0, inp["affine"])  # (r_c, r_s, t_x, t_y)
    t = t / t[:, :2].norm(dim=1, keepdim=True)
    eye = torch.eye(3, device=w0.device)
    m_r = eye.repeat(batch, 1, 1)  # the inverse rotation of the image
    m_r[:, 0, 0] = t[:, 0]
    m_r[:, 0, 1] = -t[:, 1]
    m_r[:, 1, 0] = t[:, 1]
    m_r[:, 1, 1] = t[:, 0]
    m_t = eye.repeat(batch, 1, 1)  # its inverse translation
    m_t[:, 0, 2] = -t[:, 2]
    m_t[:, 1, 2] = -t[:, 3]
    with exact_fp32():
        transforms = m_r @ m_t @ inp["transform"].float()[None]
        freqs = inp["freqs"].float()[None]  # (1, C, 2)
        phases = inp["phases"].float()[None] + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]  # (B, C, 2)
    amplitudes = (1 - (freqs.norm(dim=2) - inp_geo.bandwidth)
                  / (inp_geo.sampling_rate / 2 - inp_geo.bandwidth)).clamp(0, 1)
    with exact_fp32():
        x = (prepared.grid.unsqueeze(3) @ freqs.permute(0, 2, 1)[:, None, None]).squeeze(3)
    x = x + phases[:, None, None, :]
    x = torch.sin(x * (np.pi * 2)) * amplitudes[:, None, None, :]
    x = x @ prepared.mix  # the tier's precision, as the convs
    return x.permute(0, 3, 1, 2).contiguous()


def _layer(x: torch.Tensor, layer: Dict[str, Any], w_row: torch.Tensor) -> torch.Tensor:
    geo: LayerGeometry = layer["geometry"]
    styles = _affine(w_row, layer["affine"])
    if geo.is_torgb:
        styles = styles * (1.0 / math.sqrt(geo.in_channels * geo.kernel ** 2))
    else:
        styles = styles * styles.square().mean(dim=1, keepdim=True).rsqrt()
    y, demod = styled_conv2d(x, styles, layer["weight"], demodulate=not geo.is_torgb,
                             w_sq_sum=layer["w_sq_sum"], input_gain=layer["input_gain"],
                             padding=geo.kernel - 1)
    if geo.is_torgb:  # gain 1, slope 1, no filters: bias and clamp
        return bias_act(y, layer["bias"], clamp=geo.clamp)
    return filtered_lrelu(y, geo.up_filter, geo.down_filter, layer["bias"], geo.up, geo.down,
                          geo.padding, geo.gain, geo.slope, geo.clamp, scale=demod)


def _synthesis_layers(prepared: PreparedGenerator, x: torch.Tensor, dlatents: torch.Tensor,
                      uint8_output: bool) -> torch.Tensor:
    for i, layer in enumerate(prepared.layers):
        x = _layer(x, layer, dlatents[:, i + 1])
    image = (x * prepared.config.output_scale).permute(0, 2, 3, 1)
    return images_to_uint8(image) if uint8_output else image


def _check(compute_dtype: torch.dtype, noise_mode: str,
           phase_top_block_mode: Optional[bool]) -> None:
    """The arguments StyleGAN2's signature has that StyleGAN3-T takes one way only."""
    if compute_dtype != torch.float32:
        raise ValueError(f"StyleGAN3 runs in float32 only, not {compute_dtype}")
    if noise_mode != "const":
        raise ValueError(f"StyleGAN3-T has no noise inputs: noise_mode 'const', not {noise_mode!r}")
    if phase_top_block_mode:
        raise ValueError("StyleGAN3 has no polyphase top block")


def synthesis_apply(params: Any, dlatents: torch.Tensor, config: StyleGAN3Config,
                    compute_dtype: torch.dtype = torch.float32,
                    uint8_output: bool = False, noise_mode: str = "const",
                    phase_top_block_mode: Optional[bool] = None) -> torch.Tensor:
    """w+ (B, num_style_rows, dlatent) -> (B, resolution, resolution, 3) NHWC
    float (about [-1, 1]), or uint8 with `uint8_output`. `params` is a tree
    or a `PreparedGenerator`. `noise_mode` and `phase_top_block_mode` are
    StyleGAN2's, taken so both families share one signature."""
    _check(compute_dtype, noise_mode, phase_top_block_mode)
    prepared = as_prepared(params, config)
    apply_conv_precision()
    dlatents = dlatents.float()
    with span("model.sg3.input"):
        x = synthesis_input(prepared, dlatents[:, 0])
    return _synthesis_layers(prepared, x, dlatents, uint8_output)


def generator_apply(params: Any, z: torch.Tensor, config: StyleGAN3Config,
                    truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI,
                    compute_dtype: torch.dtype = torch.float32,
                    uint8_output: bool = False, noise_mode: str = "const",
                    phase_top_block_mode: Optional[bool] = None) -> torch.Tensor:
    """z -> mapping -> broadcast -> truncation -> synthesis."""
    _check(compute_dtype, noise_mode, phase_top_block_mode)
    prepared = as_prepared(params, config)
    with span("model.sg3.input"):
        dlatents = broadcast_dlatents(mapping_apply(prepared.params, z, config), config)
        if truncation_psi is not None and truncation_psi != 1.0:
            dlatents = truncate_dlatents(dlatents, prepared.params["mapping"]["w_avg"],
                                         truncation_psi)
        x = synthesis_input(prepared, dlatents[:, 0])
    return _synthesis_layers(prepared, x, dlatents, uint8_output)
