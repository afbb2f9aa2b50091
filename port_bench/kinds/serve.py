"""
Kind `serve`: online serving, `/synthesize` of a `SynthesisDaemon`
(serving/daemon.py over serving/batcher.py) in a child process
(harness/serve_child.py), under an open loop of requests sent from this
process: Poisson arrivals at the mix's fixed rate, each request a few z
rows of its own (uniform in [rows_min, rows_max]) and the npy egress.

Each request is timed from when it was due to be sent until its npy body is
read and decoded here; a request that fails counts in `failed` and as an
infinite latency. The window is the schedule's length; every request due in
it is waited for, up to a minute past its close. The child is the only
process on the card until it has exited; the reference runs after that, on
a sample of the requests drawn from the seed, the longest among them.

Mix keys: rate_per_s, rows_min, rows_max, shape_seed, max_batch,
max_delay_ms, format, sample_requests, sample_longest.
"""

import http.client
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import program, traffic, weights
from port_bench.harness.manifest import BENCH_DIR
from port_bench.harness.result import Outcome
from port_bench.harness.trace import TraceSummary
from port_bench.reference import stylegan2 as reference

LATE_WAIT_S = 60.0


class Child:
    """The daemon's process: started, commanded line by line, and always
    stopped and waited for."""

    def __init__(self, cell: Any, seed: int, device: str, scratch: str) -> None:
        spec = Path(scratch) / "cell.json"
        spec.write_text(json.dumps({"config": cell.config, "traffic": cell.traffic}))
        self.proc = subprocess.Popen(
            [sys.executable, str(BENCH_DIR / "harness" / "serve_child.py"), str(spec), str(seed),
             device], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def expect(self, word: str) -> str:
        line = self.proc.stdout.readline()
        if not line.startswith(word):
            raise RuntimeError(f"serve child: expected {word!r}, got {line!r} "
                               f"(exit {self.proc.poll()})")
        return line.strip()

    def command(self, text: str, reply: str) -> str:
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()
        return self.expect(reply)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def get_json(port: int, path: str) -> Dict[str, Any]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def post(port: int, body: bytes, rows: int, side: int) -> np.ndarray:
    """One request; its frames as the client decodes them."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=LATE_WAIT_S + 600)
    try:
        conn.request("POST", "/synthesize", body=body,
                     headers={"Content-Type": "application/json"})
        response = conn.getresponse()
        payload = response.read()
        if response.status != 200:
            raise RuntimeError(f"HTTP {response.status}: {payload[:200]!r}")
        frames = np.load(io.BytesIO(payload), allow_pickle=False)
    finally:
        conn.close()
    if frames.shape != (rows, side, side, 3) or frames.dtype != np.uint8:
        raise RuntimeError(f"frames {frames.shape} {frames.dtype}, asked for {rows} rows")
    return frames


def sample_requests(rows: np.ndarray, mix: Dict[str, Any], seed: int) -> List[int]:
    """Requests whose frames are compared: `sample_longest` of those with
    the most rows and the rest at random, drawn from the seed."""
    draw = traffic.rng(seed, 7)
    longest = np.flatnonzero(rows == rows.max())
    chosen = set(draw.choice(longest, size=min(mix["sample_longest"], len(longest)),
                             replace=False).tolist())
    rest = [i for i in draw.permutation(len(rows)).tolist() if i not in chosen]
    chosen.update(rest[:max(0, mix["sample_requests"] - len(chosen))])
    return sorted(chosen)


def drive(port: int, bodies: List[bytes], rows: np.ndarray, sends: np.ndarray, seconds: float,
          side: int, sampled: set, threads: int) -> Dict[str, Any]:
    """The open loop: request i is sent at window start + sends[i] from a
    pool of threads, whatever the earlier ones are doing. Returns the window
    start, each request's latency (inf where it failed or never came),
    the sampled requests' frames, the errors and how late each send was."""
    latencies = np.full(len(rows), np.inf)
    kept: Dict[int, np.ndarray] = {}
    errors: List[str] = []
    lock = threading.Lock()

    def one(i: int, due: float) -> None:
        try:
            frames = post(port, bodies[i], int(rows[i]), side)
            done = time.perf_counter()
            with lock:
                latencies[i] = done - due
                if i in sampled:
                    kept[i] = frames
        except Exception as error:  # a failed request counts; the run goes on
            with lock:
                errors.append(f"request {i}: {error}")

    lateness = []
    pool = ThreadPoolExecutor(max_workers=threads)
    window_start = time.perf_counter() + 0.05
    futures = []
    for i, offset in enumerate(sends):
        due = window_start + offset
        pause = due - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        lateness.append(time.perf_counter() - due)
        futures.append(pool.submit(one, i, due))
    close = window_start + seconds
    try:
        for future in futures:
            future.result(timeout=max(0.1, close + LATE_WAIT_S - time.perf_counter()))
    except FuturesTimeout:
        with lock:
            errors.append(f"requests unanswered {LATE_WAIT_S} s past the window's close")
    pool.shutdown(wait=False, cancel_futures=True)
    with lock:
        return {"window_start": window_start, "window_s": time.perf_counter() - window_start,
                "latencies": latencies.copy(), "kept": dict(kept), "errors": list(errors),
                "lateness": lateness}


def run(cell: Any, seed: int, seconds: float, trace: bool, device: str) -> Outcome:
    mix, config = cell.traffic, cell.config
    side = config["resolution"]
    sends, rows = traffic.open_loop_schedule(mix["rate_per_s"], seconds, mix["rows_min"],
                                             mix["rows_max"], mix["shape_seed"])
    z = traffic.z_rows(int(rows.sum()), config["latent_size"], seed)
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
    bodies = [json.dumps({"latents": z[s:s + r].tolist(), "format": mix["format"]}).encode()
              for s, r in zip(starts, rows)]
    sampled = set(sample_requests(rows, mix, seed))

    scratch = tempfile.mkdtemp(prefix="port_bench_serve_")
    child = Child(cell, seed, device, scratch)
    try:
        port = int(child.expect("ready").split()[1])
        before = get_json(port, "/stats")
        if trace:
            child.command("trace_start", "tracing")
        load = drive(port, bodies, rows, sends, seconds, side, sampled,
                     mix.get("client_threads", 96))
        window_start, latencies, kept = load["window_start"], load["latencies"], load["kept"]
        window_s = load["window_s"]
        summary: Optional[TraceSummary] = None
        if trace:
            path = Path(scratch) / "trace.json"
            child.command(f"trace_stop {path}", "traced")
            data = json.loads(path.read_text())
            summary = TraceSummary(data["busy_s"], data["window_s"], data["device_ops"],
                                   data["breakdown"])
        after = get_json(port, "/stats")
        peak_path = Path(scratch) / "peak.json"
        child.command(f"exit {peak_path}", "bye")
        child.proc.wait(timeout=120)
        held = json.loads(peak_path.read_text())
        peak, banned = held["memory_peak_bytes"], held["banned_modules"]
    finally:
        child.close()
        for leftover in Path(scratch).glob("*"):
            leftover.unlink()
        Path(scratch).rmdir()
    for line in load["errors"][:5]:
        print(f"port_bench: {line}", file=sys.stderr)

    # the reference, on the card once the daemon's process has ended
    params = weights.generator_params(config, seed, device)
    got, want = [], []
    for i in sorted(kept):
        zi = torch.from_numpy(z[starts[i]:starts[i] + rows[i]]).to(device)
        want += list(reference.frames_from_z(params, zi, config).cpu().numpy())
        got += list(kept[i])
    del params
    program.free(device)  # a later daemon process on this card gets it whole
    from port_bench.harness.compare import frame_numbers

    numbers = frame_numbers(got, want)
    failed = int(np.count_nonzero(~np.isfinite(latencies)))
    batches = after["batches"] - before["batches"]
    return Outcome(
        window_start=window_start,
        e2e={"request_p95_ms": float(np.percentile(latencies, 95)) * 1e3},
        attempted=len(rows), failed=failed, numbers=numbers, memory_peak_bytes=peak,
        banned_modules=banned,
        layer={"trace": summary, "config": config, "mix": mix, "window_s": window_s,
               "batches": batches, "rows": after["frames"] - before["frames"]},
    )
