"""
Network-quality evaluation during training: the counterpart of
gance_tpu/metrics/training_eval.py.

`cli/train.py --metrics-every N` evaluates the EMA generator's PPL and Fréchet
feature distance against the training set at checkpoint boundaries and
appends one JSON line per evaluation to a sidecar JSONL, so a training run
produces its own quality curve. Both metrics run over the pluggable
perceptual features (projection/lpips.py), so values compare only within one
metric configuration, which is what a training curve needs.

The port evaluates the EMA params where they live (the training device),
under `torch.inference_mode`, on a copy; JAX copies them to the host first.
The metrics draw from their own CPU generators, so an evaluation changes
neither the training state nor any draw of the trainer.
"""

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from gance_tpu_torch.models.stylegan2 import GeneratorConfig
from gance_tpu_torch.utils.logging import LOGGER


def evaluate_training_metrics(
    ema_params: Dict[str, Any],
    model_config: GeneratorConfig,
    perceptual_params: Dict[str, Any],
    dataset_directory: Path,
    step: int,
    num_samples: int = 64,
    batch_size: int = 8,
    seed: int = 0,
) -> Dict[str, Any]:
    """
    One evaluation of the EMA generator: PPL (w/full, the headline NVlabs
    configuration) + Fréchet feature distance vs the training images. Returns
    the JSONL record (finite floats; provenance included).

    `num_samples` bounds BOTH metrics' sample counts: training-time evals
    favor cheap, comparable-across-steps numbers over publication precision.
    It runs on the device of the EMA params (the CPU for numpy arrays).
    """
    from gance_tpu_torch.metrics.frechet import frechet_distance_network_vs_images
    from gance_tpu_torch.metrics.ppl import perceptual_path_length

    device = torch.as_tensor(ema_params["dlatent_avg"]).device
    started = time.monotonic()
    ppl = perceptual_path_length(
        ema_params,
        model_config,
        perceptual_params,
        num_samples=num_samples,
        batch_size=batch_size,
        space="w",
        sampling="full",
        seed=seed,
        device=device,
    )
    frechet = frechet_distance_network_vs_images(
        ema_params,
        model_config,
        perceptual_params,
        Path(dataset_directory),
        num_samples=num_samples,
        batch_size=batch_size,
        seed=seed,
        device=device,
    )
    record = {
        "step": int(step),
        "ppl_w_full": float(ppl.ppl),
        "frechet_feature_distance": float(frechet["distance"]),
        "num_samples": int(num_samples),
        "feature_dim": int(frechet["feature_dim"]),
        "eval_seconds": round(time.monotonic() - started, 3),
    }
    LOGGER.info(
        "metrics @ step %d: ppl=%.4g frechet=%.4g (%.1fs)",
        record["step"],
        record["ppl_w_full"],
        record["frechet_feature_distance"],
        record["eval_seconds"],
    )
    return record


def append_metrics_record(path: Optional[Path], record: Dict[str, Any]) -> None:
    """Append one JSON line (parent dirs created; numpy scalars coerced)."""
    if path is None:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    clean = {
        key: (value.item() if isinstance(value, np.generic) else value)
        for key, value in record.items()
    }
    with path.open("a", encoding="utf-8") as handle:
        handle.write(json.dumps(clean) + "\n")
