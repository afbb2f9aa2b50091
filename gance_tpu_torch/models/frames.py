"""
A batch to uint8 frames, for every caller and both model families: the one
place that maps a config to its family's code and decides how a batch
becomes frames. `synthesis/runtime.py::SynthesisNetwork`,
`parallel/network_parallel.py` and `parallel/sharded_synthesis.py` all
render through `frames`.

  * A (B, latent) batch of z runs the whole generator: mapping, truncation
    at `truncation_psi`, synthesis. A (B, rows, dlatent) batch of w+ runs
    synthesis alone: projection latents are final.
  * Noise is the network's constant buffers.
  * At the network's resolution the uint8 conversion is fused into the
    family's synthesis (`uint8_output`). At another `output_side_length` the
    float render is resized on the device (`resize_images`, JAX's bicubic)
    and then quantised.

Each family module has the same entry points: `prepare(params_on_device,
config)`, made once a network, then `generator_apply` and `synthesis_apply`
on what it returned. Both quantise through their own module's
`images_to_uint8`, so a test that patches that name sees every frame.
"""

from types import ModuleType
from typing import Any, Optional, Union

import torch

from gance_tpu_torch.models import stylegan2, stylegan3

Config = Union[stylegan2.GeneratorConfig, stylegan3.StyleGAN3Config]

# The only table from a config's type to its family's code.
FAMILIES = {stylegan2.GeneratorConfig: stylegan2, stylegan3.StyleGAN3Config: stylegan3}


def family(config: Config) -> ModuleType:
    """The module of `config`'s model family."""
    try:
        return FAMILIES[type(config)]
    except KeyError:
        raise TypeError(f"no model family for a {type(config).__name__}") from None


def prepare(params: Any, config: Config) -> Any:
    """A params tree already on its device, made ready for `frames`."""
    return family(config).prepare(params, config)


def frames(
    prepared: Any,
    batch: torch.Tensor,
    config: Config,
    *,
    truncation_psi: Optional[float],
    compute_dtype: torch.dtype,
    output_side_length: Optional[int] = None,
    phase_top_block_mode: Optional[bool] = None,
) -> torch.Tensor:
    """
    (B, latent) z or (B, rows, dlatent) w+ on the device -> (B, S, S, 3)
    uint8 on the device (queued, not synced); S is `output_side_length`, or
    the resolution. `prepared` is `prepare`'s result, or a StyleGAN2 tree
    of a tensor-parallel model group (`GroupParams`).
    `phase_top_block_mode` as `stylegan2.synthesis_apply` takes it; a family
    without a polyphase top block refuses True.
    """
    model = family(config)
    fused = output_side_length in (None, config.resolution)
    if batch.ndim == 2:
        images = model.generator_apply(
            prepared, batch, config, truncation_psi=truncation_psi, noise_mode="const",
            compute_dtype=compute_dtype, phase_top_block_mode=phase_top_block_mode,
            uint8_output=fused)
    elif batch.ndim == 3:
        images = model.synthesis_apply(
            prepared, batch, config, noise_mode="const", compute_dtype=compute_dtype,
            phase_top_block_mode=phase_top_block_mode, uint8_output=fused)
    else:
        raise ValueError(f"Cannot dispatch batch of shape {tuple(batch.shape)}")
    if fused:
        return images
    return model.images_to_uint8(stylegan2.resize_images(images, output_side_length))
