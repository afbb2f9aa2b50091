"""
StyleGAN2 (config-f family) in PyTorch: the generator (mapping, synthesis and
the uint8 output transform) and the resnet discriminator.

The counterpart of gance_tpu/models/stylegan2.py, with
the same weight semantics (equalized-LR "unit" parameterization,
modulation/demodulation, binomial resampling FIR, noise injection, skip-
architecture ToRGB chain) and the same params tree keys
(params["synthesis"]["64x64"]["Conv0_up"]["weight"]). Layouts are PyTorch's:

  * activations NCHW, conv weights OIHW (Cout, Cin, kh, kw),
  * 4x4/Const/const (1, C, 4, 4) and noise buffers (1, 1, H, W), both as the
    TF pickle stores them,
  * dense and style-affine weights (in, out), as in the pickle; the
    discriminator's 4x4/Dense0 keeps the pickle's row order, since the port
    flattens NCHW features as TF does (JAX permutes it to NHWC order).

Functions take a params tree of tensors on one device, or a `Layers` that
runs each layer its own way (`parallel/tensor_parallel.py::GroupParams`, a
tensor-parallel model group). The noise-carrying
layers' epilogue runs through kernel A (`fused_bias_noise_lrelu`), the skip
chain's upsample through kernel B and the up-conv's blur through kernel C.
With the polyphase top block (`phase_top_block_mode`, GANCE_TPU_PHASE1024) the
top block runs in phase space (ops/phase_block.py) and its Conv1, epilogue and
ToRGB through kernel E. The discriminator's downsampling blurs run through
kernel D.
"""

import math
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gance_tpu_torch.ops import phase_block
from gance_tpu_torch.ops.bias_act import bias_act
from gance_tpu_torch.ops.cuda.fused_ops import RGB_COLUMNS, fused_bias_noise_lrelu
from gance_tpu_torch.ops.modulated_conv import (
    conv2d_layer,
    dense_layer,
    modulated_conv2d,
    modulated_conv2d_undemodulated,
    runtime_weight_coef,
)
from gance_tpu_torch.ops.precision import apply_conv_precision, exact_fp32
from gance_tpu_torch.ops.upfirdn2d import conv_downsample_blur, upsample_2d_nchw

Params = Dict[str, Any]

# The reference's inference-time truncation: psi > 1 expands the deviation from
# the average dlatent.
DEFAULT_TRUNCATION_PSI = 1.2


@dataclass(frozen=True)
class GeneratorConfig:
    """Static architecture hyperparameters (config-f defaults at 1024px)."""

    resolution: int = 1024
    latent_size: int = 512
    dlatent_size: int = 512
    num_channels: int = 3
    fmap_base: int = 32768
    fmap_decay: float = 1.0
    fmap_min: int = 1
    fmap_max: int = 512
    mapping_layers: int = 8
    mapping_fmaps: int = 512
    mapping_lrmul: float = 0.01
    resample_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    # mbstd settings only matter for the discriminator / training.
    mbstd_group_size: int = 4
    mbstd_num_features: int = 1

    @property
    def resolution_log2(self) -> int:
        return int(math.log2(self.resolution))

    @property
    def num_style_rows(self) -> int:
        """18 at 1024px."""
        return self.resolution_log2 * 2 - 2

    def nf(self, stage: int) -> int:
        """Feature-map count at a stage (NVlabs nf())."""
        return int(
            np.clip(
                int(self.fmap_base / (2.0 ** (stage * self.fmap_decay))),
                self.fmap_min,
                self.fmap_max,
            )
        )

    def block_resolutions(self) -> Tuple[int, ...]:
        """Synthesis block output resolutions above 4: (8, 16, ..., resolution)."""
        return tuple(2**res for res in range(3, self.resolution_log2 + 1))


# ---------------------------------------------------------------------------
# Initialization: the shapes and distributions of gance_tpu's
# init_generator_params (weights ~ N(0, 1), mapping weights ~ N(0, 1/lrmul^2),
# zero biases / strengths / dlatent_avg, N(0, 1) const and noise), drawn from a
# numpy RandomState, in the port's layouts.
# ---------------------------------------------------------------------------


def _conv_layer_params(
    rng: np.random.RandomState, kernel: int, cin: int, cout: int, dlatent_size: int,
    with_noise: bool,
) -> Params:
    params: Params = {
        "weight": rng.standard_normal((cout, cin, kernel, kernel)).astype(np.float32),
        "mod_weight": rng.standard_normal((dlatent_size, cin)).astype(np.float32),
        "mod_bias": np.zeros((cin,), np.float32),
        "bias": np.zeros((cout,), np.float32),
    }
    if with_noise:
        params["noise_strength"] = np.zeros((), np.float32)
    return params


def init_generator_params(seed: int, config: GeneratorConfig) -> Params:
    """Random generator params (mapping + synthesis + noise) as numpy float32."""
    rng = np.random.RandomState(seed)
    mapping: Params = {}
    fan_in = config.latent_size
    for i in range(config.mapping_layers):
        fmaps = config.dlatent_size if i == config.mapping_layers - 1 else config.mapping_fmaps
        mapping[f"Dense{i}"] = {
            "weight": (
                rng.standard_normal((fan_in, fmaps)) / config.mapping_lrmul
            ).astype(np.float32),
            "bias": np.zeros((fmaps,), np.float32),
        }
        fan_in = fmaps

    synthesis: Params = {
        "4x4": {
            "Const": {
                "const": rng.standard_normal((1, config.nf(1), 4, 4)).astype(np.float32)
            },
            "Conv": _conv_layer_params(
                rng, 3, config.nf(1), config.nf(1), config.dlatent_size, True
            ),
            "ToRGB": _conv_layer_params(
                rng, 1, config.nf(1), config.num_channels, config.dlatent_size, False
            ),
        }
    }
    for res in range(3, config.resolution_log2 + 1):
        cin, cout = config.nf(res - 2), config.nf(res - 1)
        synthesis[f"{2**res}x{2**res}"] = {
            "Conv0_up": _conv_layer_params(rng, 3, cin, cout, config.dlatent_size, True),
            "Conv1": _conv_layer_params(rng, 3, cout, cout, config.dlatent_size, True),
            "ToRGB": _conv_layer_params(
                rng, 1, cout, config.num_channels, config.dlatent_size, False
            ),
        }
    synthesis["noise"] = {}
    for layer_idx in range(config.num_style_rows - 1):
        size = 2 ** ((layer_idx + 5) // 2)  # noise0 -> 4x4, noise1/2 -> 8x8, ...
        synthesis["noise"][f"noise{layer_idx}"] = rng.standard_normal(
            (1, 1, size, size)
        ).astype(np.float32)
    return {
        "mapping": mapping,
        "synthesis": synthesis,
        "dlatent_avg": np.zeros((config.dlatent_size,), np.float32),
    }


def init_discriminator_params(seed: int, config: GeneratorConfig) -> Params:
    """Random resnet discriminator params (config-f D_stylegan2) as numpy
    float32: the shapes of gance_tpu's init_discriminator_params in the port's
    layouts (conv weights OIHW), weights ~ N(0, 1), zero biases."""
    rng = np.random.RandomState(seed)
    top = config.resolution_log2

    def conv(kernel: int, cin: int, cout: int, with_bias: bool = True) -> Params:
        p = {"weight": rng.standard_normal((cout, cin, kernel, kernel)).astype(np.float32)}
        if with_bias:
            p["bias"] = np.zeros((cout,), np.float32)
        return p

    params: Params = {f"{2**top}x{2**top}": {"FromRGB": conv(1, config.num_channels, config.nf(top - 1))}}
    for res in range(top, 2, -1):
        block = params.setdefault(f"{2**res}x{2**res}", {})
        block["Conv0"] = conv(3, config.nf(res - 1), config.nf(res - 1))
        block["Conv1_down"] = conv(3, config.nf(res - 1), config.nf(res - 2))
        block["Skip"] = conv(1, config.nf(res - 1), config.nf(res - 2), with_bias=False)
    params["4x4"] = {
        "Conv": conv(3, config.nf(1) + config.mbstd_num_features, config.nf(1)),
        "Dense0": {
            "weight": rng.standard_normal((config.nf(1) * 16, config.nf(0))).astype(np.float32),
            "bias": np.zeros((config.nf(0),), np.float32),
        },
    }
    # the final dense is a top-level scope of its own in the TF variable tree
    params["Output"] = {
        "weight": rng.standard_normal((config.nf(0), 1)).astype(np.float32),
        "bias": np.zeros((1,), np.float32),
    }
    return params


def config_from_params(params: Params) -> GeneratorConfig:
    """Infer the architecture config from a generator params tree (port layout)."""
    synthesis = params["synthesis"]
    resolution = max(int(k.split("x")[0]) for k in synthesis if "x" in k and k[0].isdigit())
    top_log2 = int(math.log2(resolution))
    top_channels = synthesis[f"{resolution}x{resolution}"]["Conv1"]["weight"].shape[0]
    dense0 = params["mapping"]["Dense0"]["weight"]
    return GeneratorConfig(
        resolution=resolution,
        latent_size=int(dense0.shape[0]),
        dlatent_size=int(synthesis["4x4"]["Conv"]["mod_weight"].shape[0]),
        mapping_layers=len([k for k in params["mapping"] if k.startswith("Dense")]),
        mapping_fmaps=int(dense0.shape[1]),
        fmap_base=int(top_channels * (2 ** (top_log2 - 1))),
        fmap_max=int(synthesis["4x4"]["Conv"]["weight"].shape[0]),
    )


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

Path = Tuple[str, ...]


class Layers:
    """
    How the forwards below run each layer of a params tree: `run(path, fn,
    x, *extras)` is `fn(layer, x, *extras)` with the layer's params, on their
    device, and `layer(path)` is the layer's params whole. The seam of
    tensor parallelism: `parallel/tensor_parallel.py::GroupParams` runs a
    sharded layer column-parallel over a model group's slots instead.
    `phase_channels` says that fn's output channels are phase planes (ph * C
    + c), for a runner that gathers channel blocks.
    """

    def __init__(self, params: Params) -> None:
        self.params = params

    def __getitem__(self, key: str) -> Any:
        return self.params[key]

    def layer(self, path: Path) -> Params:
        tree = self.params
        for key in path:
            tree = tree[key]
        return tree

    def run(self, path: Path, fn: Callable[..., torch.Tensor], x: torch.Tensor,
            *extras: Optional[torch.Tensor], phase_channels: bool = False) -> torch.Tensor:
        return fn(self.layer(path), x, *extras)


def as_layers(params: Any) -> Layers:
    """A params tree's direct `Layers`, or `params` when it is one already."""
    return params if isinstance(params, Layers) else Layers(params)


def mapping_apply(
    params: Params, z: torch.Tensor, config: GeneratorConfig, lrmul: Optional[float] = None
) -> torch.Tensor:
    """
    G_mapping in fp32 at any compute dtype: pixel-norm the latent, then the
    equalized-LR dense + lrelu layers (bias times lrmul 0.01).
    :param z: (B, latent_size). :return: w (B, dlatent_size).
    """
    layers = as_layers(params)
    apply_conv_precision()
    lrmul = config.mapping_lrmul if lrmul is None else lrmul
    x = z.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)

    def dense(layer: Params, xs: torch.Tensor) -> torch.Tensor:
        return bias_act(dense_layer(xs, layer["weight"], lrmul=lrmul), layer["bias"] * lrmul,
                        act="lrelu")

    mapping = layers["mapping"]
    for name in sorted((k for k in mapping if k.startswith("Dense")), key=lambda s: int(s[5:])):
        x = layers.run(("mapping", name), dense, x)
    return x


def broadcast_dlatents(w: torch.Tensor, config: GeneratorConfig) -> torch.Tensor:
    """(B, 512) -> w+ (B, num_style_rows, 512)."""
    return w[:, None, :].expand(-1, config.num_style_rows, -1).contiguous()


def truncate_dlatents(
    dlatents: torch.Tensor,
    dlatent_avg: torch.Tensor,
    psi: float = DEFAULT_TRUNCATION_PSI,
    cutoff: Optional[int] = None,
) -> torch.Tensor:
    """w' = w_avg + (w - w_avg) * psi, optionally only for style rows below `cutoff`."""
    avg = dlatent_avg.to(dlatents.dtype)
    if cutoff is None:
        return avg + (dlatents - avg) * psi
    rows = torch.arange(dlatents.shape[1], device=dlatents.device)
    layer_psi = torch.where(rows < cutoff, psi, 1.0).to(dlatents.dtype)[None, :, None]
    return avg + (dlatents - avg) * layer_psi


def _synthesis_layer(
    x: torch.Tensor,
    layer_params: Params,
    dlatent_row: torch.Tensor,
    noise: Optional[torch.Tensor],
    up: bool,
    config: GeneratorConfig,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """conv (maybe up) -> noise inject -> bias + lrelu (NVlabs `layer()`). With
    noise, kernel A applies the conv's demodulation in its own pass."""
    y, demod = modulated_conv2d_undemodulated(
        x, dlatent_row, layer_params["weight"], layer_params["mod_weight"],
        layer_params["mod_bias"], up=up, demodulate=True,
        resample_kernel=config.resample_kernel, compute_dtype=compute_dtype,
    )
    if noise is None:
        return bias_act(y * demod[:, :, None, None].to(y.dtype), layer_params["bias"], act="lrelu")
    return fused_bias_noise_lrelu(y, noise, layer_params["bias"], layer_params["noise_strength"],
                                  scale=demod)


def _torgb(
    x: torch.Tensor,
    layer_params: Params,
    dlatent_row: torch.Tensor,
    y: Optional[torch.Tensor],
    config: GeneratorConfig,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """1x1 modulated conv (no demod) + bias; skip-add the upsampled RGB trunk."""
    t = modulated_conv2d(
        x, dlatent_row, layer_params["weight"], layer_params["mod_weight"],
        layer_params["mod_bias"], demodulate=False,
        resample_kernel=config.resample_kernel, compute_dtype=compute_dtype,
    )
    t = t + layer_params["bias"].to(t.dtype)[None, :, None, None]
    return t if y is None else y + t


def phase_mode_from_env() -> str:
    """GANCE_TPU_PHASE1024: 'auto' (default), 'on' or 'off', case-insensitive;
    any other value raises."""
    mode = os.environ.get("GANCE_TPU_PHASE1024", "auto").strip().lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"GANCE_TPU_PHASE1024={mode!r}: expected 'auto', 'on', or 'off'")
    return mode


def resolve_phase_top_block(config: GeneratorConfig, mode: Optional[bool] = None) -> bool:
    """
    Whether the top block runs in polyphase form, decided once per call.
    `mode` True / False forces it on / off; None reads GANCE_TPU_PHASE1024,
    whose 'auto' is off here in every compute dtype: JAX turns it on only on a
    TPU backend, and on the H100 the phase path is the slower one (PERF.md).
    As in JAX, never at a top block of 128 channels or more (the fold would
    only add work), and only for a symmetric separable 4-tap FIR; kernel E
    also needs at most 4 output channels (its 16 RGB phase columns).
    """
    if mode is None:
        mode = phase_mode_from_env() == "on"
    return (bool(mode) and config.nf(config.resolution_log2 - 1) < 128
            and phase_block.phase_path_supported(config.resample_kernel)
            and 4 * config.num_channels <= RGB_COLUMNS)


def synthesis_apply(
    params: Params,
    dlatents: torch.Tensor,
    config: GeneratorConfig,
    noise_mode: str = "const",
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
    phase_top_block_mode: Optional[bool] = None,
    uint8_output: bool = False,
    noise_planes: Optional[Sequence[torch.Tensor]] = None,
    remat: bool = False,
) -> torch.Tensor:
    """
    G_synthesis (skip architecture): w+ (B, num_style_rows, 512) -> image
    (B, resolution, resolution, 3) NHWC float in about [-1, 1], or uint8 when
    `uint8_output`.

    :param noise_mode: 'const' (the params' noise buffers), 'random' (fresh
        N(0, 1) noise per sample and layer, drawn from `generator`, which must
        live on the params' device, or taken from `noise_planes`) or 'none'.
    :param noise_planes: with noise_mode 'random', the noise of every
        noise-carrying layer, given instead of drawn: layer i's plane is
        (B, 1, s, s) with s = 2 ** ((i + 5) // 2) (the trainer draws a step's
        planes up front, `parallel/training.py::draw_step`).
    :param phase_top_block_mode: True / False force the polyphase top block
        on / off (on only where the top block has fewer than 128 channels and
        the FIR and channel count fit it); None resolves GANCE_TPU_PHASE1024.
    :param uint8_output: on the phase path the skip add, bias and quantisation
        run per phase (`phase_top_block_uint8`, bit for bit
        `images_to_uint8` of the float output); elsewhere `images_to_uint8`.
    :param remat: under autograd, recompute each block (and the phase top
        block) in the backward pass instead of keeping its activations: one
        non-reentrant `torch.utils.checkpoint` per block. A block's noise is
        drawn before its checkpoint, so the recompute sees the same planes.
        With remat the uint8 output keeps the float path, as in JAX.

    `params` may also be a `Layers` (a tensor-parallel model group's
    `GroupParams`), which runs each layer its own way.
    """
    layers = as_layers(params)
    if noise_mode not in ("const", "random", "none"):
        raise ValueError(f"bad noise_mode {noise_mode!r}")
    if noise_planes is not None and noise_mode != "random":
        raise ValueError("noise_planes are the planes of noise_mode='random'")
    if noise_mode == "random" and generator is None and noise_planes is None:
        raise ValueError("noise_mode='random' requires a torch.Generator or noise_planes")
    apply_conv_precision()
    synthesis = layers["synthesis"]
    noise_buffers = synthesis.get("noise", {})
    batch = dlatents.shape[0]

    def layer_noise(layer_idx: int, size: int) -> Optional[torch.Tensor]:
        if noise_mode == "const":
            return noise_buffers.get(f"noise{layer_idx}")
        if noise_planes is not None:
            return noise_planes[layer_idx]
        if noise_mode == "random":
            return torch.randn(
                (batch, 1, size, size), generator=generator, device=dlatents.device
            )
        return None

    def conv(key: str, name: str, x: torch.Tensor, dl: torch.Tensor,
             noise: Optional[torch.Tensor], up: bool) -> torch.Tensor:
        return layers.run(
            ("synthesis", key, name), lambda p, xs, d, n: _synthesis_layer(
                xs, p, d, n, up, config, compute_dtype), x, dl, noise)

    def torgb(key: str, x: torch.Tensor, dl: torch.Tensor,
              y: Optional[torch.Tensor]) -> torch.Tensor:
        t = layers.run(("synthesis", key, "ToRGB"),
                       lambda p, xs, d: _torgb(xs, p, d, None, config, compute_dtype), x, dl)
        return t if y is None else y + t

    const = synthesis["4x4"]["Const"]["const"].to(compute_dtype)
    x = const.expand(batch, -1, -1, -1).contiguous()
    x = conv("4x4", "Conv", x, dlatents[:, 0], layer_noise(0, 4), False)
    y = torgb("4x4", x, dlatents[:, 1], None)

    top = config.resolution_log2
    use_phase = resolve_phase_top_block(config, phase_top_block_mode)

    checkpointed = remat and torch.is_grad_enabled()

    def block_fn(x: torch.Tensor, y: torch.Tensor, key: str, dl_rows: Tuple[torch.Tensor, ...],
                 noise_up: Optional[torch.Tensor],
                 noise_c1: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        x = conv(key, "Conv0_up", x, dl_rows[0], noise_up, True)
        x = conv(key, "Conv1", x, dl_rows[1], noise_c1, False)
        y = upsample_2d_nchw(y, kernel=config.resample_kernel)
        return x, torgb(key, x, dl_rows[2], y)

    def phase_args(key: str) -> Tuple[Params, Callable[..., torch.Tensor]]:
        # Conv1 and ToRGB are kernel E's operands, whole; Conv0_up runs as a
        # layer (phase planes out)
        block = {name: layers.layer(("synthesis", key, name)) for name in ("Conv1", "ToRGB")}

        def upconv(x: torch.Tensor, dl_up: torch.Tensor,
                   noise_up: Optional[torch.Tensor]) -> torch.Tensor:
            return layers.run(
                ("synthesis", key, "Conv0_up"), lambda p, xs, d, n: phase_block.phase_upconv(
                    xs, p, d, n, config.resample_kernel, compute_dtype),
                x, dl_up, noise_up, phase_channels=True)

        return block, upconv

    def phase_fn(x: torch.Tensor, key: str, dl_rows: Tuple[torch.Tensor, ...],
                 noise_up: Optional[torch.Tensor], noise_c1: Optional[torch.Tensor],
                 y: torch.Tensor) -> torch.Tensor:
        block, upconv = phase_args(key)
        return phase_block.phase_top_block(x, block, dl_rows, noise_up, noise_c1, y,
                                           config.resample_kernel, compute_dtype, upconv=upconv)

    for res in range(3, top + 1):
        key = f"{2**res}x{2**res}"
        size = 2**res
        dl_rows = (dlatents[:, res * 2 - 5], dlatents[:, res * 2 - 4], dlatents[:, res * 2 - 3])
        # both layers' noise, in draw order, outside any checkpoint
        noise_up = layer_noise(res * 2 - 5, size)
        noise_c1 = layer_noise(res * 2 - 4, size)
        if res == top and use_phase:
            if uint8_output and not remat:
                block, upconv = phase_args(key)
                return phase_block.phase_top_block_uint8(
                    x, block, dl_rows, noise_up, noise_c1, y, config.resample_kernel,
                    compute_dtype, upconv=upconv,
                )
            y = upsample_2d_nchw(y, kernel=config.resample_kernel)
            if checkpointed:
                y = checkpoint(phase_fn, x, key, dl_rows, noise_up, noise_c1, y,
                               use_reentrant=False)
            else:
                y = phase_fn(x, key, dl_rows, noise_up, noise_c1, y)
            break
        if checkpointed:
            x, y = checkpoint(block_fn, x, y, key, dl_rows, noise_up, noise_c1,
                              use_reentrant=False)
        else:
            x, y = block_fn(x, y, key, dl_rows, noise_up, noise_c1)

    image = y.permute(0, 2, 3, 1).float()
    return images_to_uint8(image) if uint8_output else image


def prepare(params: Params, config: GeneratorConfig) -> Params:
    """The params as every forward takes them: StyleGAN2 makes nothing ahead."""
    return params


def generator_apply(
    params: Params,
    z: torch.Tensor,
    config: GeneratorConfig,
    truncation_psi: Optional[float] = DEFAULT_TRUNCATION_PSI,
    noise_mode: str = "const",
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
    phase_top_block_mode: Optional[bool] = None,
    uint8_output: bool = False,
) -> torch.Tensor:
    """Full G: z -> mapping -> broadcast -> truncation -> synthesis."""
    w = mapping_apply(params, z, config)
    dlatents = broadcast_dlatents(w, config)
    if truncation_psi is not None and truncation_psi != 1.0:
        dlatents = truncate_dlatents(dlatents, params["dlatent_avg"], truncation_psi)
    return synthesis_apply(
        params, dlatents, config, noise_mode=noise_mode, generator=generator,
        compute_dtype=compute_dtype, phase_top_block_mode=phase_top_block_mode,
        uint8_output=uint8_output,
    )


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 at |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    """The linear (triangle) kernel at |distance| x."""
    return np.maximum(0.0, 1.0 - x)


_RESIZE_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


@lru_cache(maxsize=32)
def resize_matrix(in_size: int, out_size: int, method: str = "cubic") -> np.ndarray:
    """
    (in_size, out_size) float32 weights of jax.image.resize(method=`method`,
    "cubic" or "linear") along one axis (jax/_src/image/scale.py::
    compute_weight_mat, computed in float32 as JAX does): half-pixel sample
    positions, the kernel widened by 1/scale when downscaling (antialiasing),
    each column normalised to sum 1, and columns whose sample lies outside the
    input zeroed. Cached, so it is returned read-only.
    """
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _RESIZE_KERNELS[method](x).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, 0).astype(f32)
    weights.setflags(write=False)
    return weights


def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """`resize_matrix` of jax.image.resize(method="cubic")."""
    return resize_matrix(in_size, out_size, "cubic")


def resize_images(images: torch.Tensor, side_length: int, method: str = "cubic") -> torch.Tensor:
    """
    Resize float NHWC images on their device, as jax.image.resize does:
    "cubic" (the default, gance_tpu's `resize_images`: the Keys cubic with
    a = -0.5) or "linear" (a triangle filter), both antialiased on downscale.
    Two products with the per-axis weight matrices, in exact fp32.
    F.interpolate's bicubic (a = -0.75) and bilinear do not antialias, so they
    are not this function.
    """
    _, h, w, _ = images.shape
    out = images.float()
    with exact_fp32():
        if h != side_length:
            wh = torch.tensor(resize_matrix(h, side_length, method), device=images.device)
            out = torch.einsum("bhwc,hy->bywc", out, wh)
        if w != side_length:
            ww = torch.tensor(resize_matrix(w, side_length, method), device=images.device)
            out = torch.einsum("bywc,wx->byxc", out, ww)
    return out


def images_to_uint8(
    images: torch.Tensor, drange: Tuple[float, float] = (-1.0, 1.0)
) -> torch.Tensor:
    """Float NHWC -> uint8 NHWC: floor(x * 127.5 + 128), then clip (no rounding)."""
    lo, hi = drange
    scale = 255.0 / (hi - lo)
    x = images * scale + (0.5 - lo * scale)
    return torch.clamp(torch.floor(x), 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Discriminator (resnet architecture), for training
# ---------------------------------------------------------------------------


def minibatch_stddev(
    x: torch.Tensor, group_size: int = 4, num_new_features: int = 1,
    full: Optional[torch.Tensor] = None, offset: int = 0,
) -> torch.Tensor:
    """
    Append the cross-minibatch stddev feature maps to NCHW x (in fp32, as
    gance_tpu does, then cast back to x's dtype). The groups are strided over
    the batch: sample i falls in group i mod (n / g).

    Under data parallelism x holds rows [offset, offset + len(x)) of a larger
    batch, and `full` (that whole batch, gathered differentiably) supplies
    the groups, so that the statistics are the whole batch's, as JAX's
    sharded step computes them.
    """
    batch = x if full is None else full
    n, c, h, w = batch.shape
    g = min(group_size, n)
    if n % g != 0:
        g = 1
    y = batch.reshape(g, n // g, num_new_features, c // num_new_features, h, w).float()
    y = y - y.mean(dim=0, keepdim=True)
    y = y.square().mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(2, 3, 4))  # over the channel split, H and W: (n // g, F)
    y = y.repeat(g, 1)[offset: offset + x.shape[0]].to(x.device)  # sample i: group i mod n/g
    y = y.reshape(x.shape[0], num_new_features, 1, 1).expand(-1, -1, h, w).to(x.dtype)
    return torch.cat([x, y], dim=1)


def discriminator_apply(
    params: Params,
    images: torch.Tensor,
    config: GeneratorConfig,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> torch.Tensor:
    """
    D_stylegan2 (resnet): images (B, R, R, 3) NHWC, as synthesis returns them
    -> fp32 logits (B, 1). Runs NCHW inside; each block's Conv1_down and Skip
    blur through kernel D.

    :param remat: under autograd, recompute each resnet block in the backward
        pass instead of keeping its activations (one non-reentrant
        `torch.utils.checkpoint` per block).
    """
    return discriminator_head(
        params, discriminator_features(params, images, config, compute_dtype, remat), config)


def _conv_lrelu(layers: Layers, path: Path, x: torch.Tensor) -> torch.Tensor:
    return layers.run(path, lambda p, xs: bias_act(conv2d_layer(xs, p["weight"]), p["bias"],
                                                   act="lrelu"), x)


def _conv_down(layers: Layers, path: Path, x: torch.Tensor,
               kernel: Tuple[int, ...]) -> torch.Tensor:
    """`conv2d_layer(x, weight, down=True)`: the blur (kernel D) once on x,
    then the layer's strided conv."""
    blurred = conv_downsample_blur(x, layers.layer(path)["weight"].shape[2], kernel)

    def strided(layer: Params, xs: torch.Tensor) -> torch.Tensor:
        _, cin, kh, kw = layer["weight"].shape
        w = layer["weight"].to(xs.dtype) * runtime_weight_coef(kh * kw * cin)
        return F.conv2d(xs, w, stride=2)

    return layers.run(path, strided, blurred)


def discriminator_features(
    params: Params,
    images: torch.Tensor,
    config: GeneratorConfig,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> torch.Tensor:
    """D's resnet trunk: images (B, R, R, 3) -> NCHW features at 4x4, the
    input of the minibatch stddev (`discriminator_head`). `params` may be a
    `Layers`, as in `synthesis_apply`."""
    layers = as_layers(params)
    apply_conv_precision()
    top = config.resolution_log2
    # contiguous NCHW: from a permuted NHWC input cuDNN would emit channels-last
    # activations, which the kernels do not take
    x = images.permute(0, 3, 1, 2).to(compute_dtype).contiguous()
    x = _conv_lrelu(layers, (f"{2**top}x{2**top}", "FromRGB"), x)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)

    def d_block(x: torch.Tensor, key: str) -> torch.Tensor:
        t = x
        x = _conv_lrelu(layers, (key, "Conv0"), x)
        x = _conv_down(layers, (key, "Conv1_down"), x, config.resample_kernel)
        x = bias_act(x, layers[key]["Conv1_down"]["bias"], act="lrelu")
        t = _conv_down(layers, (key, "Skip"), t, config.resample_kernel)
        return (x + t) * inv_sqrt2

    checkpointed = remat and torch.is_grad_enabled()
    for res in range(top, 2, -1):
        key = f"{2**res}x{2**res}"
        x = checkpoint(d_block, x, key, use_reentrant=False) if checkpointed else d_block(x, key)
    return x


def discriminator_head(
    params: Params,
    x: torch.Tensor,
    config: GeneratorConfig,
    full: Optional[torch.Tensor] = None,
    offset: int = 0,
) -> torch.Tensor:
    """D's 4x4 block and dense layers: trunk features -> fp32 logits (B, 1).
    `full` and `offset` place x in a larger batch for the minibatch stddev
    (`minibatch_stddev`)."""
    layers = as_layers(params)
    x = minibatch_stddev(x, config.mbstd_group_size, config.mbstd_num_features, full, offset)
    x = _conv_lrelu(layers, ("4x4", "Conv"), x)
    x = x.reshape(x.shape[0], -1)  # NCHW order, the pickle's Dense0 row order
    x = layers.run(("4x4", "Dense0"), lambda p, xs: bias_act(dense_layer(xs, p["weight"]),
                                                             p["bias"], act="lrelu"), x)
    x = layers.run(("Output",), lambda p, xs: bias_act(dense_layer(xs, p["weight"]), p["bias"]), x)
    return x.float()
