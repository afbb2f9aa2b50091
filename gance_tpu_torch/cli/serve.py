"""
CLI: run the port's online synthesis HTTP daemon (`gance_tpu_torch/serving/`),
the counterpart of gance_tpu/cli/serve.py with its options plus --device.

    python -m gance_tpu_torch.cli.serve --networks-directory nets --device cuda

It loads generator pickles, builds the CUDA kernels first (on CUDA; a failed
build stops the server), warms every bucket the batcher can dispatch, binds
the port and serves until SIGTERM or SIGINT; SIGTERM drains (in-flight
requests finish, new ones get 503) and the process exits 0. See
`serving/daemon.py` for the routes.

The body is `run_server`, a plain function that imports no click (the card
machine's tools run it in a child process); click is imported only by
`build_cli`. --use-mesh, --data-parallel, --dist-*, --control-port and
--control-bind serve over several devices or processes, which is not ported
yet: they raise naming ROADMAP.md Queue 1 item 12.
"""

import signal
import threading
from pathlib import Path
from typing import Any, List, Optional, Sequence

import numpy as np

from gance_tpu_torch.utils.logging import LOGGER, add_log_file

MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"
COMPUTE_DTYPES = ("bfloat16", "float32")


def check_single_device(use_mesh: Optional[bool] = None, data_parallel: Optional[int] = None,
                        dist_coordinator: Optional[str] = None,
                        dist_num_processes: Optional[int] = None,
                        dist_process_id: Optional[int] = None,
                        control_port: Optional[int] = None,
                        control_bind: Optional[str] = None) -> None:
    """The multi-device and multi-host options raise: not ported yet."""
    given = {
        "--use-mesh": use_mesh is True, "--data-parallel": data_parallel is not None,
        "--dist-coordinator": dist_coordinator is not None,
        "--dist-num-processes": dist_num_processes is not None,
        "--dist-process-id": dist_process_id is not None,
        "--control-port": control_port is not None,
        "--control-bind": control_bind is not None,
    }
    named = [name for name, value in given.items() if value]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)}: serving over several devices or processes is not "
            f"ported yet: {MULTI_DEVICE_ITEM}"
        )


class NetworkLoader:
    """Pickles -> served networks, all with the same `SynthesisNetwork`
    options (device, dtype, psi, output side), at start-up and on
    /admin/load. Two-phase for the daemon: `prepare` parses the pickle
    outside the batcher's device lock, `commit` places it on the device
    under it."""

    def __init__(self, **network_options: Any) -> None:
        self.network_options = network_options

    @staticmethod
    def prepare(path: str, _index: int = 0):
        from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

        return SynthesisNetwork.stage_pkl(Path(path))

    def commit(self, staged, path: str, _index: int = 0):
        from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

        return SynthesisNetwork.from_staged(staged, Path(path), **self.network_options)

    def __call__(self, path: str, index: int = 0):
        return self.commit(self.prepare(path, index), path, index)


def warm_networks(networks: Sequence[Any], max_batch: int, warmup: str) -> List[int]:
    """Run every bucket size the batcher can dispatch ('all': both the z and
    the w+ lane of each network) or only `max_batch` on the z lane ('max'),
    so that no request is the first of its batch shape; returns the sizes."""
    from gance_tpu_torch.serving.batcher import warmup_batch_sizes

    if warmup == "none":
        return []
    sizes = warmup_batch_sizes(max_batch) if warmup == "all" else [max_batch]
    LOGGER.info("Warming %d network(s) at batch sizes %s (%s)", len(networks), sizes, warmup)
    for network in networks:
        vector_length = network.expected_vector_length
        for size in sizes:
            network.images_from_vectors(np.zeros((size, vector_length), np.float32))
            if warmup == "all":
                network.images_from_matrices(np.zeros(
                    (size, int(network.config.num_style_rows), vector_length), np.float32))
    LOGGER.info("Warmup complete.")
    return sizes


def warm_audio(networks: Sequence[Any], durations: Sequence[float]) -> None:
    """Plan one fabricated clip per duration (host CPU only; no device work),
    so that the first audio request of each length pays no first-call cost."""
    import base64
    import tempfile

    from gance_tpu_torch.audio.io import fabricate_percussive_wav
    from gance_tpu_torch.serving.audio import plan_audio_request

    for seconds in durations:
        LOGGER.info("Warming audio planning for %.3gs clips ...", seconds)
        with tempfile.TemporaryDirectory() as tmp:
            clip = fabricate_percussive_wav(Path(tmp) / "warm.wav", seconds=seconds).read_bytes()
        plan_audio_request(
            {"wav_base64": base64.b64encode(clip).decode()},
            networks, list(range(len(networks))),
            frame_cap=1 << 20,  # warmup never refuses on length
        )
    LOGGER.info("Audio warmup complete.")


def parse_durations(warmup_audio: Optional[str]) -> List[float]:
    """--warmup-audio's comma-separated seconds."""
    if not warmup_audio:
        return []
    try:
        return [float(v) for v in warmup_audio.split(",") if v.strip()]
    except ValueError as error:
        raise ValueError(f"--warmup-audio wants comma-separated seconds: {error}") from error


def run_server(
    network_paths: Sequence[Path],
    host: str = "127.0.0.1",
    port: int = 8799,
    max_batch: Optional[int] = None,
    max_delay_ms: float = 5.0,
    output_side_length: Optional[int] = None,
    truncation_psi: Optional[float] = None,
    compute_dtype: Optional[str] = None,
    warmup: str = "all",
    warmup_audio: Optional[str] = None,
    device: str = "cuda",
    log_path: Optional[str] = None,
    **multi_device: Any,
) -> None:
    """Serve `network_paths` until SIGTERM (drain, then return) or SIGINT."""
    import torch

    from gance_tpu_torch.serving import SynthesisDaemon, default_max_batch
    from gance_tpu_torch.utils.device import resolve_device

    check_single_device(**multi_device)
    if log_path:
        add_log_file(Path(log_path))
    if not network_paths:
        raise ValueError("No networks given: pass network paths, a directory or a JSON file")
    if warmup not in ("all", "max", "none"):
        raise ValueError(f"--warmup must be all, max or none, got {warmup!r}")
    durations = parse_durations(warmup_audio)
    resolved = resolve_device(device)
    if resolved.type == "cuda":
        from gance_tpu_torch.ops.cuda import build

        build.build_all()  # before any network is bound; a failed build raises

    kwargs: dict = {"device": resolved, "output_side_length": output_side_length}
    if truncation_psi is not None:
        kwargs["truncation_psi"] = truncation_psi
    if compute_dtype is not None:
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"--compute-dtype must be one of {COMPUTE_DTYPES}")
        kwargs["compute_dtype"] = getattr(torch, compute_dtype)

    loader = NetworkLoader(**kwargs)
    networks = [loader(str(p), i) for i, p in enumerate(network_paths)]
    resolved_batch = max_batch if max_batch is not None else default_max_batch()
    warm_networks(networks, resolved_batch, warmup)
    warm_audio(networks, durations)

    with SynthesisDaemon(networks, host=host, port=port, max_batch=resolved_batch,
                         max_delay_ms=max_delay_ms, network_loader=loader) as daemon:
        print(f"serving {', '.join(str(p) for p in network_paths)} on "
              f"http://{host}:{daemon.port} (max_batch={resolved_batch}, "
              f"linger={max_delay_ms}ms, device={resolved})", flush=True)
        stop_requested = threading.Event()
        drain = threading.Event()

        def on_sigterm(_signum, _frame) -> None:
            LOGGER.info("SIGTERM: draining the synthesis daemon")
            drain.set()
            stop_requested.set()

        previous = signal.signal(signal.SIGTERM, on_sigterm)
        try:
            while not stop_requested.wait(0.1):
                pass
        except KeyboardInterrupt:
            LOGGER.info("shutting down synthesis daemon")
        finally:
            signal.signal(signal.SIGTERM, previous)
        if drain.is_set():
            # in-flight requests finish, new ones get 503, then the context
            # manager stops the server and the batcher
            daemon.drain()


def build_cli():
    """The click command over `run_server` (click is imported here only)."""
    import click

    from gance_tpu_torch.cli.common import resolve_networks

    @click.command()
    @click.option(
        "--network-path", type=click.Path(exists=True, dir_okay=False), multiple=True,
        help="Generator .pkl to serve (repeat to serve several resident networks; "
        "requests pick one with the 'network' field, default index 0).",
    )
    @click.option(
        "--networks-directory", type=click.Path(exists=True, file_okay=False), default=None,
        help="Serve every *.pkl in this directory (sorted), like the render CLIs.",
    )
    @click.option(
        "--networks-json", type=click.Path(exists=True, dir_okay=False), default=None,
        help='JSON file {"networks": [paths...]} of pickles to serve.',
    )
    @click.option("--host", default="127.0.0.1", show_default=True)
    @click.option(
        "--port", type=click.IntRange(min=0), default=8799, show_default=True,
        help="0 binds an ephemeral port (printed at startup).",
    )
    @click.option(
        "--max-batch", type=click.IntRange(min=1), default=None,
        help="Device batch ceiling (default: GANCE_TPU_SERVE_BATCH or 48; keep it "
        "a multiple of 8).",
    )
    @click.option(
        "--max-delay-ms", type=click.FloatRange(min=0), default=5.0, show_default=True,
        help="Coalescing linger: how long a request waits for company before the "
        "batch dispatches (latency traded for occupancy).",
    )
    @click.option(
        "--output-side-length", type=click.IntRange(min=1), default=None,
        help="Scale frames to this side on the device before egress (native "
        "resolution when unset).",
    )
    @click.option("--truncation-psi", type=float, default=None,
                  help="Override the serving default truncation psi.")
    @click.option(
        "--compute-dtype", type=click.Choice(list(COMPUTE_DTYPES)), default=None,
        help="Synthesis compute dtype (default: GANCE_TPU_COMPUTE_DTYPE, float32).",
    )
    @click.option("--use-mesh/--no-mesh", "use_mesh", default=None,
                  help="Not ported yet (--use-mesh raises): serve over a device mesh.")
    @click.option("--data-parallel", type=click.IntRange(min=1), default=None,
                  help="Not ported yet (raises): the serving mesh's data axis.")
    @click.option("--dist-coordinator", type=str, default=None,
                  help="Not ported yet (raises): multi-host serving.")
    @click.option("--dist-num-processes", type=int, default=None)
    @click.option("--dist-process-id", type=int, default=None)
    @click.option("--control-port", type=click.IntRange(min=0), default=None,
                  help="Not ported yet (raises): the multi-host control channel.")
    @click.option("--control-bind", type=str, default=None,
                  help="Not ported yet (raises): the multi-host control channel.")
    @click.option("--log", "log_path", type=click.Path(dir_okay=False), default=None)
    @click.option(
        "--warmup", type=click.Choice(["all", "max", "none"]), default="all",
        show_default=True,
        help="Batches to run before binding the port: 'all' = every bucket size "
        "the batcher can dispatch, on both the z and w+ lanes; 'max' = the full "
        "batch on the z lane; 'none' = bind at once.",
    )
    @click.option(
        "--warmup-audio", type=str, default=None,
        help="Comma-separated clip durations in seconds (e.g. '2,5,30'): plan "
        "one fabricated clip of each on the host CPU before binding.",
    )
    @click.option(
        "--device", type=str, default="cuda", show_default=True,
        help="Torch device for synthesis ('cuda' or 'cpu'); planning runs on the CPU.",
    )
    def cli(network_path, networks_directory, networks_json, **options) -> None:
        """Serve one or more generators over HTTP with dynamic request batching."""
        try:
            paths = resolve_networks(networks_directory, network_path, networks_json)
        except ValueError as error:  # no sources given or a bad JSON file
            raise click.UsageError(str(error)) from error
        try:
            parse_durations(options["warmup_audio"])
        except ValueError as error:
            raise click.UsageError(str(error)) from error
        run_server(paths, **options)

    return cli


def main() -> None:
    build_cli()()


if __name__ == "__main__":
    main()
