#!/usr/bin/env python3
"""
The port's own spans and counters (`gance_tpu_torch/utils/profiling.py`) on
the benchmark's cells, read where the benchmark does not read them.

    python3 tools/trace_torch_spans.py render --workload f256-render --pairs 2
    python3 tools/trace_torch_spans.py serve --workload f1024-serve

`render` runs the cell's traced window (`port_bench/kinds/render.py`, under
torch.profiler) with the program's recording on and with it off, in turns
(on, off, off, on for each pair, a seed each), and prints one JSON line a
run: the traced window's frames/s (the cost of recording is the difference),
the runtime metrics, the device idle share, the harness's breakdown of the
idle gaps, the idle seconds split exactly by the runtime span open at each
instant (no look-back limit; "caller" is outside every runtime span), and
the host's blocking CUDA calls (count and seconds).

`serve` starts the daemon of the serve cell in a process of its own
(`serve-child`), profiles it under `profiling.trace()` while this process
sends the cell's open loop, and prints one JSON line: the split of each
request's server time into parse, queue wait (submit to the dispatch of its
last rows), in flight (dispatch to resolve) and egress (resolve to the end
of the write), as means over every request and over the slowest 5% by
server time; what the batcher's dispatch thread was doing during those
requests' queue waits; and the client's latency quantiles.

The serve modes stand until the benchmark's own serve child passes the
daemon's spans through (PERF.md section 7), and go then.

`--device cpu --resolution 32 --seconds 2` runs either on the CPU as a
rehearsal. Each line also goes to `--out` when given.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RUNTIME_METRICS = ("idle_in_dispatch_share.render", "dispatch_ms_per_frame.render",
                   "pad_row_share.render", "device_idle_share.render")
# innermost first: idle time goes to the first of these open at the instant
RUNTIME_SPANS = ("runtime.forward", "runtime.host_copy", "runtime.dispatch_window",
                 "runtime.await_window", "runtime.deliver")
DISPATCH_STEPS = ("serving.batcher.await_request", "serving.batcher.linger",
                  "serving.batcher.assemble", "serving.batcher.issue",
                  "serving.batcher.backpressure")


def emit(record: Dict[str, Any], out: Optional[str]) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a", encoding="utf-8") as handle:
            handle.write(line + "\n")


def load_cell(args: argparse.Namespace) -> Any:
    from port_bench.harness import manifest

    cell = manifest.load_cell(args.workload)
    if args.resolution:
        cell.config.update(resolution=args.resolution)
    return cell


def idle_by_span(trace: Any) -> Dict[str, float]:
    """Idle seconds of the window split by the innermost runtime span open."""
    from port_bench.harness.spans import intersect, merged, overlap, span_intervals

    gaps = trace.idle_gaps()
    covered: List = []
    split = {}
    for name in RUNTIME_SPANS:
        own = span_intervals(trace, name)
        # the part of this span's time not already given to an inner one
        total = overlap(gaps, own) - overlap(intersect(gaps, own), merged(covered))
        split[name] = total * 1e-6
        covered += own
    split["caller"] = (sum(e - s for s, e in gaps) - overlap(gaps, merged(covered))) * 1e-6
    return split


def host_waits(trace: Any) -> Dict[str, List[float]]:
    """The host's blocking CUDA calls in the window: [count, seconds] by name."""
    lo, hi = trace.window
    waits: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, start, dur in trace.host_ops:
        if "Synchronize" in name and lo <= start < hi:
            waits[name][0] += 1
            waits[name][1] += dur * 1e-6
    return dict(waits)


def render(args: argparse.Namespace) -> None:
    from types import SimpleNamespace

    from port_bench.harness import device as dev
    from port_bench.harness import manifest

    dev.program_environment()
    import gance_tpu_torch.synthesis.runtime as runtime
    from gance_tpu_torch.utils import profiling

    cell = load_cell(args)
    kind = manifest.kind_module(cell.traffic["kind"])
    recording = (runtime.span, runtime.count)
    seed = args.seed
    for pair in range(args.pairs):
        for on in (True, False, False, True):
            runtime.span, runtime.count = recording if on else (
                lambda name, **ids: profiling.NULL_SPAN, lambda name, n=1: None)
            profiling.reset()
            seed += 1
            outcome = kind.run(cell, seed, args.seconds, True, args.device)
            ctx = SimpleNamespace(**outcome.layer)
            metrics = {name: manifest.layer_metric_reader(name).read(ctx)
                       for name in RUNTIME_METRICS}
            trace = ctx.trace
            emit({"mode": "render", "workload": cell.name, "pair": pair, "recording": on,
                  "seed": seed, "frames_per_s_traced": outcome.e2e["frames_per_s"],
                  "frames": ctx.frames, "window_s": ctx.window_s, "metrics": metrics,
                  "counters": profiling.counters(),
                  "busy_s": trace.busy_s, "trace_window_s": trace.window_s,
                  "idle_by_span_s": idle_by_span(trace), "host_waits": host_waits(trace),
                  "breakdown": trace.breakdown(), **device_line(args.device)}, args.out)
    runtime.span, runtime.count = recording


def device_line(device: str) -> Dict[str, Any]:
    import torch

    if not device.startswith("cuda"):
        return {"device": "cpu"}
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "smi": limit.stdout.strip()}


def serve_child(args: argparse.Namespace) -> None:
    """The daemon's process: ready <port>, then `start <dir>`, `stop <json>`
    and `exit` on its standard input."""
    from contextlib import ExitStack

    import torch

    from port_bench.harness import device as dev

    dev.program_environment()
    from port_bench.harness import program, traffic, weights
    from port_bench.harness.serve_child import warm_requests

    cell = load_cell(args)
    mix, config = cell.traffic, cell.config
    program.build_kernels(args.device)
    from gance_tpu_torch.serving.batcher import warmup_batch_sizes
    from gance_tpu_torch.serving.daemon import SynthesisDaemon
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork
    from gance_tpu_torch.utils import profiling

    net = SynthesisNetwork(params=weights.generator_params(config, args.seed, args.device),
                           config=program.generator_config(config),
                           truncation_psi=config["truncation_psi"],
                           compute_dtype=torch.float32, device=args.device)
    warm = traffic.z_rows(mix["max_batch"], config["latent_size"], args.seed, stream=5)
    for rows in warmup_batch_sizes(mix["max_batch"]):
        net.images_from_vectors(warm[:rows])
    daemon = SynthesisDaemon(net, port=0, max_batch=mix["max_batch"],
                             max_delay_ms=mix["max_delay_ms"]).start()
    warm_requests(daemon.port, warm, mix)
    program.synchronize(args.device)
    print(f"ready {daemon.port}", flush=True)
    stack = ExitStack()
    trace_dir = None
    for line in sys.stdin:
        command, _, arg = line.strip().partition(" ")
        if command == "start":
            trace_dir = Path(arg)
            stack.enter_context(profiling.trace(trace_dir))
            print("tracing", flush=True)
        elif command == "stop":
            program.synchronize(args.device)
            started = time.perf_counter()
            stack.close()
            export_s = time.perf_counter() - started
            trace_file = next(trace_dir.glob("trace.*.json"), None)
            summary = split_requests(profiling.spans())
            summary["trace_export_s"] = export_s
            summary["trace_bytes"] = trace_file.stat().st_size if trace_file else None
            summary["exported_thread_spans"] = thread_spans_in(trace_file)
            summary["stats"] = daemon.batcher.stats()
            Path(arg).write_text(json.dumps(summary))
            print("stopped", flush=True)
        elif command == "exit":
            daemon.drain(timeout_s=120)
            daemon.stop()
            print("bye", flush=True)
            return


def thread_spans_in(path: Optional[Path]) -> Dict[str, int]:
    """Spans of the daemon's threads in the exported trace, by name."""
    if path is None:
        return {}
    events = json.loads(path.read_text())["traceEvents"]
    counts: Dict[str, int] = defaultdict(int)
    for event in events:
        if event.get("ph") in ("X", "b") and str(event.get("name", "")).startswith("serving."):
            counts[event["name"]] += 1
    return dict(counts)


def split_requests(recorded: List[Any]) -> Dict[str, Any]:
    """Each request's server time split by its spans (microseconds in, ms
    out): parse, queue wait, in flight, egress."""
    import numpy as np

    from port_bench.harness.spans import merged, overlap

    by_request: Dict[int, Dict[str, Any]] = defaultdict(dict)
    for item in recorded:
        request = item.ids.get("request")
        if request is not None:
            by_request[request][item.name] = item
    rows = []
    for request, own in by_request.items():
        need = ("serving.http.parse", "serving.queue_wait", "serving.request",
                "serving.http.write")
        if not all(k in own for k in need):
            continue
        parse, wait = own["serving.http.parse"], own["serving.queue_wait"]
        whole, write = own["serving.request"], own["serving.http.write"]
        rows.append({"request": request,
                     "total": (write.end_us - parse.start_us) / 1e3,
                     "parse": (wait.start_us - parse.start_us) / 1e3,
                     "queue_wait": (wait.end_us - wait.start_us) / 1e3,
                     "in_flight": (whole.end_us - wait.end_us) / 1e3,
                     "egress": (write.end_us - whole.end_us) / 1e3,
                     "wait": (wait.start_us, wait.end_us)})
    rows.sort(key=lambda r: r["total"])
    slow = rows[int(len(rows) * 0.95):]
    parts = ("total", "parse", "queue_wait", "in_flight", "egress")

    def means(chosen: List[Dict[str, Any]]) -> Dict[str, float]:
        return {k: float(np.mean([r[k] for r in chosen])) for k in parts} if chosen else {}

    steps = {name: merged([(s.start_us, s.end_us) for s in recorded if s.name == name])
             for name in DISPATCH_STEPS}
    during = {}
    waits = merged([r["wait"] for r in slow])
    for name, own in steps.items():
        during[name] = overlap(waits, own) / 1e3 / max(1, len(slow))
    return {"requests": len(rows), "slowest": len(slow), "mean_all_ms": means(rows),
            "mean_slowest_ms": means(slow),
            "slowest_total_ms": [r["total"] for r in slow],
            "dispatch_thread_during_slowest_waits_ms": during,
            "total_p50_ms": rows[len(rows) // 2]["total"] if rows else None,
            "total_p95_ms": rows[min(len(rows) - 1, int(len(rows) * 0.95))]["total"]
            if rows else None}


def serve(args: argparse.Namespace) -> None:
    import numpy as np

    from port_bench.harness import device as dev
    from port_bench.harness import manifest, traffic

    dev.program_environment()
    cell = load_cell(args)
    mix, config = cell.traffic, cell.config
    kind = manifest.kind_module("serve")
    sends, rows = traffic.open_loop_schedule(mix["rate_per_s"], args.seconds, mix["rows_min"],
                                             mix["rows_max"], mix["shape_seed"])
    z = traffic.z_rows(int(rows.sum()), config["latent_size"], args.seed)
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
    bodies = [json.dumps({"latents": z[s:s + r].tolist(), "format": mix["format"]}).encode()
              for s, r in zip(starts, rows)]
    with tempfile.TemporaryDirectory(prefix="trace_torch_spans_") as scratch:
        command = [sys.executable, __file__, "serve-child", "--workload", args.workload,
                   "--seed", str(args.seed), "--device", args.device]
        if args.resolution:
            command += ["--resolution", str(args.resolution)]
        child = subprocess.Popen(command, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 text=True)

        def say(text: str, reply: str) -> str:
            if text:
                child.stdin.write(text + "\n")
                child.stdin.flush()
            line = child.stdout.readline()
            if not line.startswith(reply):
                raise RuntimeError(f"serve child: expected {reply!r}, got {line!r}")
            return line.strip()

        try:
            port = int(say("", "ready").split()[1])
            say(f"start {scratch}/trace", "tracing")
            load = kind.drive(port, bodies, rows, sends, args.seconds, config["resolution"],
                              set(), mix.get("client_threads", 96))
            summary_path = Path(scratch) / "split.json"
            say(f"stop {summary_path}", "stopped")
            summary = json.loads(summary_path.read_text())
            say("exit", "bye")
            child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
    latencies = load["latencies"]
    emit({"mode": "serve", "workload": cell.name, "seed": args.seed,
          "rate_per_s": mix["rate_per_s"], "seconds": args.seconds,
          "client_p50_ms": float(np.percentile(latencies, 50)) * 1e3,
          "client_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
          "failed": int(np.count_nonzero(~np.isfinite(latencies))),
          **summary, **device_line(args.device)}, args.out)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mode", choices=("render", "serve", "serve-child"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=2**31 + 20)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--pairs", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--resolution", type=int, default=None,
                        help="a smaller resolution (a CPU rehearsal)")
    parser.add_argument("--out", default=None, help="append each JSON line here too")
    args = parser.parse_args()
    {"render": render, "serve": serve, "serve-child": serve_child}[args.mode](args)


if __name__ == "__main__":
    main()
