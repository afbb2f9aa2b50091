"""
Shared click option plumbing of the port's music-video commands (the
counterpart of gance_tpu/cli/common.py, with the same option names plus
--device): the common options, the network-source group and the --run-config
provenance dump. The multi-device options (--data-parallel,
--one-network-per-device, --network-parallel, --dist-*) keep their names and
raise NotImplementedError until ROADMAP.md Queue 1 item 12.

click is imported here and in the CLI modules only; nothing on the device
path imports them.
"""

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import click

from gance_tpu_torch.models.pickle_loader import parse_network_paths
from gance_tpu_torch.utils.logging import add_log_file

MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"

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
            help="Not ported yet (raises): shard synthesis over a device mesh.",
        ),
        click.option(
            "--one-network-per-device", is_flag=True, default=False,
            help="Not ported yet (raises): each network on its own device.",
        ),
        click.option(
            "--dist-coordinator", type=str, default=None,
            help="Not ported yet (raises): host:port of process 0 of a "
            "multi-host render.",
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
            help="Not ported yet (raises): all networks resident on a device mesh.",
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
) -> None:
    """The --dist-* triple: a multi-process render is not ported yet, so any of
    the three raises."""
    if any(option is not None for option in (coordinator, num_processes, process_id)):
        raise NotImplementedError(
            f"--dist-coordinator/--dist-num-processes/--dist-process-id are not "
            f"ported yet: {MULTI_DEVICE_ITEM}"
        )
