"""
The server side of kind `serve`: a `SynthesisDaemon` (serving/daemon.py)
over one network of the cell's configuration, in a process of its own, the
only one on the card while the window runs. It makes the weights from the
seed on the card, warms every batch shape the mix's requests can reach,
answers requests of its own that reach every bucket (`warm_requests`),
prints `ready <port>` and then obeys
commands on its standard input, one a line:

    trace_start         profile from here (the window's start)
    trace_stop <path>   synchronise, stop, write the window's trace summary
    exit <path>         drain, stop the daemon, write the memory peak and
                        the banned modules this process holds, exit

Run by kinds/serve.py as `python3 port_bench/harness/serve_child.py
<cell.json> <seed> <device>`, where cell.json holds the cell's configuration
and mix as the parent resolved them.
"""

import json
import sys
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))


def serve(cell_path: str, seed: int, device: str) -> None:
    cell = json.loads(Path(cell_path).read_text())
    mix, config = cell["traffic"], cell["config"]
    # the port's knobs and cache directories come from the parent's
    # environment (device.program_environment), inherited
    import torch

    from port_bench.harness import program, traffic, weights

    program.build_kernels(device)
    from gance_tpu_torch.serving.batcher import warmup_batch_sizes
    from gance_tpu_torch.serving.daemon import SynthesisDaemon
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    params = weights.generator_params(config, seed, device)
    net = SynthesisNetwork(params=params, config=program.generator_config(config),
                           truncation_psi=config["truncation_psi"],
                           compute_dtype=torch.float32, device=device)
    del params
    warm = traffic.z_rows(mix["max_batch"], config["latent_size"], seed, stream=5)
    for rows in warmup_batch_sizes(mix["max_batch"]):
        net.images_from_vectors(warm[:rows])
    daemon = SynthesisDaemon(net, port=0, max_batch=mix["max_batch"],
                             max_delay_ms=mix["max_delay_ms"]).start()
    warm_requests(daemon.port, warm, mix)
    program.synchronize(device)
    print(f"ready {daemon.port}", flush=True)

    prof = None
    span = None
    for line in sys.stdin:
        command, _, arg = line.strip().partition(" ")
        if command == "trace_start":
            from torch.profiler import ProfilerActivity, profile, record_function

            from port_bench.harness.trace import WINDOW_SPAN

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            span = record_function(WINDOW_SPAN)
            span.__enter__()
            print("tracing", flush=True)
        elif command == "trace_stop":
            program.synchronize(device)
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            write_summary(prof, arg)
            prof = span = None
            print("traced", flush=True)
        elif command == "exit":
            daemon.drain(timeout_s=120)
            daemon.stop()
            from port_bench.harness.device import banned_modules

            Path(arg).write_text(json.dumps({"memory_peak_bytes": program.memory_peak(device),
                                             "banned_modules": banned_modules()}))
            print("bye", flush=True)
            return


def warm_requests(port: int, warm, mix) -> None:
    """Requests of the largest size, 1 to max_batch / rows_max of them at
    once, three rounds each: every bucket the batcher can dispatch is met
    through HTTP, and the pinned host buffers of each are allocated and
    cached before the window."""
    from concurrent.futures import ThreadPoolExecutor

    url = f"http://127.0.0.1:{port}/synthesize"
    rows = mix["rows_max"]
    body = json.dumps({"latents": warm[:rows].tolist(), "format": mix["format"]}).encode()

    def one(_: int) -> None:
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=600) as r:
            r.read()

    most = max(1, mix["max_batch"] // rows)
    with ThreadPoolExecutor(max_workers=most) as pool:
        for concurrent in sorted({1, 2, 4, most}):
            for _ in range(3):
                list(pool.map(one, range(concurrent)))


def write_summary(prof, path: str) -> None:
    """The window's device trace, read in this process and written as the
    readings the serve cell's metrics take (json at `path`)."""
    import os
    import tempfile

    from port_bench.harness.trace import read_chrome_trace

    fd, raw = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(raw)
        trace = read_chrome_trace(raw)
    finally:
        os.unlink(raw)
    Path(path).write_text(json.dumps({
        "window": list(trace.window), "busy_s": trace.busy_s, "window_s": trace.window_s,
        "device_ops": len(trace.device_ops), "breakdown": trace.breakdown()}))


if __name__ == "__main__":
    serve(sys.argv[1], int(sys.argv[2]), sys.argv[3])
