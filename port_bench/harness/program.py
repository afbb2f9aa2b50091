"""
What the benchmark takes from the program (the `gance_tpu_torch` port):
its configuration type and its kernel build. Imported only after
device.program_environment() has pinned the port's knobs.
"""

from typing import Any, Dict

import torch

CONFIG_KEYS = ("resolution", "latent_size", "dlatent_size", "num_channels", "fmap_base",
               "fmap_decay", "fmap_min", "fmap_max", "mapping_layers", "mapping_fmaps",
               "mapping_lrmul")


def generator_config(config: Dict[str, Any]) -> Any:
    """The port's GeneratorConfig of a configuration file."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig

    return GeneratorConfig(**{k: config[k] for k in CONFIG_KEYS},
                           resample_kernel=tuple(config["resample_kernel"]))


def build_kernels(device: Any) -> float:
    """Build the port's CUDA kernels where they are missing (into
    gance_tpu_torch/ops/cuda/build/ of this checkout); seconds spent."""
    if torch.device(device).type != "cuda":
        return 0.0
    from gance_tpu_torch.ops.cuda.build import build_all

    return build_all()


def synchronize(device: Any) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: Any) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device: Any) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
