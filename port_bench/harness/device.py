"""
The card a run measures, the environment it runs the program under, and the
check that no JAX module was loaded.
"""

import os
import subprocess
import sys
from typing import Any, Dict, Iterable, List, Optional

from port_bench.harness.manifest import ROOT

# Top-level module names that a run must not hold: the JAX package and JAX.
# Compared whole, so the port (`gance_tpu_torch`) is not caught by the name
# of the package it ports.
BANNED_MODULES = ("jax", "jaxlib", "flax", "gance_tpu")

# Caches a run may build into, at fixed paths inside the checkout (the
# kernels build into gance_tpu_torch/ops/cuda/build/ by themselves).
CACHE_DIR = ROOT / ".port_bench_cache"


class NoCard(RuntimeError):
    """The run found fewer CUDA devices than its cell asks for."""


def banned_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(BANNED_MODULES))


def program_environment(precision: str = "highest") -> None:
    """Pin the port's knobs that the configuration states (read by the port
    at import) and keep every cache of the run inside the checkout."""
    os.environ["GANCE_TPU_PRECISION"] = precision
    os.environ["GANCE_TPU_COMPUTE_DTYPE"] = "float32"
    os.environ["GANCE_TPU_PHASE1024"] = "off"
    os.environ.pop("GANCE_TPU_BATCH_SIZE", None)
    os.environ.pop("GANCE_TPU_STREAM_LOOKAHEAD", None)
    os.environ.pop("GANCE_TPU_STAGE_STATS", None)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def require_cards(count: int) -> None:
    """Raise NoCard unless CUDA is there with at least `count` devices: a
    measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no card, no measurement")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell asks for {count} card(s), torch sees {torch.cuda.device_count()}")


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_record(device: Any, count: int, memory_peak_bytes: int) -> Dict[str, Any]:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(memory_peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}
