"""
Shared click option plumbing of the port's music-video commands (the
counterpart of gance_tpu/cli/common.py, with the same option names plus
--device): the common options, the network-source group and the --run-config
provenance dump. The multi-device options (--data-parallel,
--one-network-per-device, --network-parallel, --dist-*) are JAX's: one
placement flag at a time, and --dist-* joins a multi-process render in which
every process synthesizes its share and only process 0 writes.

click is imported here and in the CLI modules only; nothing on the device
path imports them.
"""

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import click

from gance_tpu_torch.models.pickle_loader import parse_network_paths
from gance_tpu_torch.utils.logging import add_log_file

EXTENSION_HDF5 = ".hdf5"
EXTENSION_MP4 = ".mp4"


def common_command_options(func: Callable) -> Callable:
    """The shared option block of `noise_blend` / `projection_file_blend`."""
    options = [
        click.option(
            "--wav", type=click.Path(exists=True, dir_okay=False), multiple=True,
            required=True, help="Path(s) to input audio, concatenated in order.",
        ),
        click.option(
            "--output-path", type=click.Path(dir_okay=False), required=True,
            help="Path to the output video.",
        ),
        click.option(
            "--networks-directory", type=click.Path(file_okay=False), default=None,
            help="Directory of network .pkl files (alphanumeric order).",
        ),
        click.option(
            "--network-path", type=click.Path(dir_okay=False), multiple=True,
            help="Explicit network .pkl path (repeatable).",
        ),
        click.option(
            "--networks-json", type=click.Path(dir_okay=False), default=None,
            help='JSON file: {"networks": [paths...]}.',
        ),
        click.option(
            "--frames-to-visualize", type=click.IntRange(min=0), default=None,
            help="Cap the number of output frames (smoke tests).",
        ),
        click.option("--output-fps", type=click.FloatRange(min=0), default=60.0),
        click.option("--output-side-length", type=click.IntRange(min=1), default=1024),
        click.option(
            "--debug-path", type=click.Path(dir_okay=False), default=None,
            help="Write the multi-tile debug video here.",
        ),
        click.option("--debug-window", type=click.IntRange(min=1), default=100),
        click.option("--debug-side-length", type=click.IntRange(min=1), default=400),
        click.option(
            "--debug-3d", is_flag=True, default=False,
            help="Add the 3D waterfall panel (full combined stream + progress "
            "marker) to the debug tiles.",
        ),
        click.option("--alpha", type=click.FloatRange(0, 1), default=0.25),
        click.option("--fft-roll-enabled", is_flag=True, default=False),
        click.option(
            "--compute-dtype", type=click.Choice(["float32", "bfloat16"]),
            default=None,
            help="Synthesis compute dtype: float32 (exact) or bfloat16 (mean uint8 "
            "delta < 2). Defaults to GANCE_TPU_COMPUTE_DTYPE.",
        ),
        click.option(
            "--trace-dir", type=click.Path(file_okay=False), default=None,
            help="Write a torch.profiler Chrome trace of the run here.",
        ),
        click.option(
            "--data-parallel", type=click.IntRange(min=1), default=None,
            help="Shard synthesis over a ('data','model') device mesh with this "
            "data-axis size; frame batches split over 'data', and the rest of the "
            "devices form a tensor-parallel 'model' axis inside each process.",
        ),
        click.option(
            "--one-network-per-device", is_flag=True, default=False,
            help="Place each network wholly on its own device; frame groups for "
            "different networks synthesize concurrently. Mutually exclusive "
            "with --data-parallel.",
        ),
        click.option(
            "--dist-coordinator", type=str, default=None,
            help="host:port of process 0. Setting this (with the two options "
            "below) joins a multi-process render: every process runs the same "
            "command with its own --dist-process-id, frame batches shard "
            "across all processes' devices (pure data parallelism unless a "
            "placement flag says otherwise), and only process 0 writes the "
            "output files.",
        ),
        click.option("--dist-num-processes", type=int, default=None),
        click.option("--dist-process-id", type=int, default=None),
        click.option(
            "--resumable", is_flag=True, default=False,
            help="Checkpoint the render every --resume-chunk-frames frames; "
            "rerun the same command to resume a killed render.",
        ),
        click.option(
            "--resume-chunk-frames", type=click.IntRange(min=1), default=300,
            help="Frames per durable chunk for --resumable (smaller = less "
            "lost work per crash, more finalize overhead).",
        ),
        click.option(
            "--network-parallel", is_flag=True, default=False,
            help="All networks resident at once on a ('network','data') mesh: "
            "each network owns a device group (data-parallel within it). Needs "
            ">= one device per network; mutually exclusive with the other "
            "placement flags.",
        ),
        click.option(
            "--fft-amplitude-range", type=(float, float), default=(-1.0, 1.0)
        ),
        click.option(
            "--device", type=str, default="cuda", show_default=True,
            help="Torch device for the audio features and synthesis ('cuda' or 'cpu').",
        ),
        click.option(
            "--run-config", type=click.Path(dir_okay=False), default=None,
            help="Dump the resolved CLI arguments to this JSON path.",
        ),
        click.option("--log", type=click.Path(dir_okay=False), default=None),
    ]
    for option in reversed(options):
        func = option(func)
    return func


def resolve_networks(
    networks_directory: Optional[str],
    network_path: tuple,
    networks_json: Optional[str],
) -> List[Path]:
    """Merge the three network sources."""
    return parse_network_paths(
        networks_directory=Path(networks_directory) if networks_directory else None,
        network_paths=[Path(p) for p in network_path] if network_path else None,
        networks_json=Path(networks_json) if networks_json else None,
    )


def dump_run_config(run_config: Optional[str], arguments: Dict[str, Any]) -> None:
    """--run-config: reproducibility dump."""
    if run_config is None:
        return
    serializable = {
        key: (
            str(value)
            if isinstance(value, Path)
            else [str(v) for v in value]
            if isinstance(value, (list, tuple))
            else value
        )
        for key, value in arguments.items()
    }
    Path(run_config).write_text(json.dumps(serializable, indent=2))


def setup_log(log: Optional[str]) -> None:
    add_log_file(Path(log) if log else None)


def maybe_initialize_distributed(
    coordinator: Optional[str],
    num_processes: Optional[int],
    process_id: Optional[int],
    device: str = "cuda",
) -> None:
    """
    Join the torch.distributed group when the --dist-* triple is given
    (all or none). Run it before any mesh is built or network loaded. The
    backend follows from the ranks' devices (`parallel/distributed.py`).
    """
    triple = (coordinator, num_processes, process_id)
    if all(option is None for option in triple):
        return
    if any(option is None for option in triple):
        raise click.UsageError(
            "--dist-coordinator, --dist-num-processes and --dist-process-id "
            "must be given together"
        )
    from gance_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(coordinator, num_processes, process_id, device=device)
