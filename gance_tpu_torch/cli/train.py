"""
CLI: train StyleGAN2 on an image folder with the port, with crash-resume.

The counterpart of gance_tpu/cli/train.py (`--device cuda` by default,
`--device cpu` to run on the CPU): the loop is
`parallel/training.py::run_training` over `parallel/data.py`'s streaming
dataset. It checkpoints every N steps, resumes from the checkpoint
automatically, and exports the EMA generator as an NVlabs-format .pkl that
both packages load. `--metrics-every N` evaluates the EMA generator's PPL and
Fréchet feature distance at checkpoint boundaries into a JSONL sidecar.

    python -m gance_tpu_torch.cli.train --dataset-directory images \
        --resolution 64 --checkpoint-path ckpt.pkl --output-network net.pkl

With more than one device (this process's, times the processes of
--dist-*) the steps run data-parallel over a ('data', 'model') mesh, as
JAX's CLI does: `--data-parallel N` sizes the data axis, and the remainder
(devices / N) is a tensor-parallel 'model' axis inside each process.
`--dist-coordinator host:port --dist-num-processes P
--dist-process-id i` joins P processes; --batch-size is then per process,
each process reads its shard of the images, and only process 0 writes the
checkpoint and the network. --metrics-every is single-process only.
"""

import json
from pathlib import Path
from typing import Any, Optional

import click

from gance_tpu_torch.utils.device import params_to_device


@click.command()
@click.option("--dataset-directory", type=click.Path(exists=True, file_okay=False), required=True)
@click.option("--resolution", type=click.IntRange(min=16), default=64)
@click.option("--batch-size", type=click.IntRange(min=1), default=8)
@click.option("--total-steps", type=click.IntRange(min=1), default=1000)
@click.option("--learning-rate", type=float, default=0.002)
@click.option("--r1-gamma", type=float, default=10.0)
@click.option(
    "--pl-weight", type=float, default=2.0,
    help="Path-length regularization weight (config-f's G regularizer); 0 disables it.",
)
@click.option("--fmap-base", type=int, default=None, help="Defaults to config-f scaling.")
@click.option("--fmap-max", type=int, default=512)
@click.option("--latent-size", type=int, default=512)
@click.option(
    "--checkpoint-path", type=click.Path(dir_okay=False), required=True,
    help="Checkpoint file; training resumes from it automatically when it exists.",
)
@click.option("--checkpoint-every", type=click.IntRange(min=1), default=200)
@click.option(
    "--output-network", type=click.Path(dir_okay=False), required=True,
    help="Write the EMA generator here as an NVlabs-format .pkl.",
)
@click.option("--data-parallel", type=int, default=None, help="Mesh data axis size.")
@click.option(
    "--compute-dtype", type=click.Choice(["float32", "bfloat16"]), default="float32",
    help="bfloat16: bf16 forward and backward, fp32 master weights, Adam, EMA and losses.",
)
@click.option(
    "--remat/--no-remat", default=False,
    help="Recompute G and D blocks in the backward pass (torch.utils.checkpoint): "
    "less device memory for more forward work.",
)
@click.option(
    "--scan-segment", type=click.IntRange(min=1), default=1,
    help="Run this many train steps per segment, with no host sync inside a "
    "segment (one copy of its batches to the device; metrics read once). "
    "Segments end at each checkpoint; best when it divides --checkpoint-every.",
)
@click.option(
    "--metrics-every", type=click.IntRange(min=1), default=None,
    help="Evaluate the EMA generator every N steps (PPL + Fréchet feature "
    "distance vs the training images) and append one JSON line per eval to "
    "--metrics-path. Evaluations run at checkpoint boundaries, so N is "
    "effectively rounded up to a multiple of --checkpoint-every.",
)
@click.option(
    "--metrics-samples", type=click.IntRange(min=2), default=64,
    help="Sample count per metric per evaluation (training-curve cheapness "
    "over publication precision).",
)
@click.option(
    "--metrics-path", type=click.Path(dir_okay=False), default=None,
    help="Metrics JSONL sidecar; default: <checkpoint-path>.metrics.jsonl.",
)
@click.option(
    "--metrics-vgg-weights", type=click.Path(exists=True, dir_okay=False), default=None,
    help="Perceptual weights for the metrics (NVlabs vgg16_zhang_perceptual.pkl "
    "or imported .npz); default: the deterministic random-VGG metric.",
)
@click.option("--seed", type=int, default=0)
@click.option(
    "--dist-coordinator", type=str, default=None,
    help="host:port of process 0. Setting this (with the two options below) joins "
    "a multi-process run: every process starts the same command with its own "
    "--dist-process-id, the devices of all processes form one mesh, and the "
    "dataset and batch shard per process (--batch-size is PER PROCESS).",
)
@click.option("--dist-num-processes", type=int, default=None)
@click.option("--dist-process-id", type=int, default=None)
@click.option("--device", type=str, default="cuda", show_default=True,
              help="Torch device to train on ('cuda' or 'cpu').")
@click.option(
    "--run-config", type=click.Path(dir_okay=False), default=None,
    help="Dump the resolved CLI arguments to this JSON path.",
)
@click.option("--log", type=click.Path(dir_okay=False), default=None)
def cli(  # pylint: disable=too-many-arguments,too-many-locals
    dataset_directory: str,
    resolution: int,
    batch_size: int,
    total_steps: int,
    learning_rate: float,
    r1_gamma: float,
    pl_weight: float,
    fmap_base: Optional[int],
    fmap_max: int,
    latent_size: int,
    checkpoint_path: str,
    checkpoint_every: int,
    output_network: str,
    data_parallel: Optional[int],
    compute_dtype: str,
    remat: bool,
    scan_segment: int,
    metrics_every: Optional[int],
    metrics_samples: int,
    metrics_path: Optional[str],
    metrics_vgg_weights: Optional[str],
    seed: int,
    dist_coordinator: Optional[str],
    dist_num_processes: Optional[int],
    dist_process_id: Optional[int],
    device: str,
    run_config: Optional[str],
    log: Optional[str],
) -> None:
    """Train StyleGAN2 on an image folder (resumable; exports a loadable .pkl)."""
    arguments = dict(locals())
    if run_config is not None:
        Path(run_config).write_text(json.dumps(arguments, indent=2))

    from gance_tpu_torch.cli.common import maybe_initialize_distributed

    if metrics_every is not None and dist_coordinator is not None:
        # checked before the rendezvous, which blocks until every process joins
        raise click.UsageError(
            "--metrics-every is single-process-only; evaluate multi-host "
            "runs offline with network_metrics.py against the exported .pkl."
        )
    maybe_initialize_distributed(dist_coordinator, dist_num_processes, dist_process_id, device)

    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel.data import StreamingImageDataset
    from gance_tpu_torch.parallel.mesh import create_mesh, global_devices, process_group_info
    from gance_tpu_torch.parallel.training import TrainingConfig, run_training
    from gance_tpu_torch.utils.logging import add_log_file

    add_log_file(Path(log) if log else None)
    model_config = GeneratorConfig(
        resolution=resolution,
        fmap_base=fmap_base if fmap_base is not None else 32768,
        fmap_max=fmap_max,
        latent_size=latent_size,
        dlatent_size=latent_size,
        mapping_fmaps=latent_size,
    )
    train_config = TrainingConfig(
        learning_rate=learning_rate, r1_gamma=r1_gamma, pl_weight=pl_weight,
        compute_dtype=compute_dtype, remat=remat,
    )
    # the batch of step s is a function of (seed + 1, s), as in gance_tpu's CLI;
    # across processes each reads its round-robin shard of the images
    process_index, process_count = process_group_info()
    dataset = StreamingImageDataset(Path(dataset_directory), resolution, seed=seed + 1,
                                    host_index=process_index, host_count=process_count)
    mesh = (create_mesh(data_parallel=data_parallel, device=device)
            if len(global_devices(device=device)) > 1 else None)
    ckpt = Path(checkpoint_path)
    metrics_file = Path(metrics_path) if metrics_path else ckpt.with_name(
        ckpt.name + ".metrics.jsonl")
    last_eval: Optional[int] = None  # the step of the last evaluation
    perceptual = None

    def note_start(step: int) -> None:
        nonlocal last_eval
        if last_eval is None:
            last_eval = step  # the run's first step: no evaluation before it

    def maybe_eval_metrics(step: int, state: Any) -> None:
        """An EMA-quality eval at a checkpoint boundary, every --metrics-every steps."""
        nonlocal last_eval, perceptual
        if step - last_eval < metrics_every:
            return
        last_eval = step
        from gance_tpu_torch.metrics.training_eval import (
            append_metrics_record,
            evaluate_training_metrics,
        )
        from gance_tpu_torch.projection.lpips import load_vgg_params, random_vgg_params

        if perceptual is None:
            perceptual = (load_vgg_params(Path(metrics_vgg_weights)) if metrics_vgg_weights
                          else random_vgg_params(seed=0))
        ema = state.ema_params
        if not isinstance(ema, dict):  # a model group: evaluate it whole on its lead
            from gance_tpu_torch.parallel.mesh import gather_params

            ema = params_to_device(gather_params(ema), ema.lead)
        record = evaluate_training_metrics(
            ema, model_config, perceptual, Path(dataset_directory), step=step,
            num_samples=metrics_samples, seed=seed,
        )
        append_metrics_record(metrics_file, record)

    run_training(
        dataset, model_config, train_config, ckpt, total_steps, batch_size,
        checkpoint_every=checkpoint_every, output_network=Path(output_network), seed=seed,
        device=device, scan_segment=scan_segment, mesh=mesh,
        before_step=note_start if metrics_every is not None else None,
        metrics_hook=maybe_eval_metrics if metrics_every is not None else None,
    )


if __name__ == "__main__":
    cli()
