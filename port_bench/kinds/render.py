"""
Kind `render`: the render stream every pipeline ends in.

The window drives `MultiNetwork.synthesize_stream` (synthesis/runtime.py)
over the mix's networks of one configuration, one z a frame, network indices
taking turns in runs of geometric length, at the mix's batch and lookahead.
Frames are consumed on the host as they come and kept only in a sample.

Mix keys: networks, mean_run_frames, block_frames, shape_seed, batch,
lookahead, max_frames_per_s (how many frames the stream is given per second
of window; the run fails if the window outruns them), sample_frames. The
networks compute in fp32 on the standard path, as the configuration states.
"""

import time
from typing import Any, List

import numpy as np
import torch

from port_bench.harness import program, traffic, weights
from port_bench.harness.result import Outcome, Reservoir
from port_bench.harness.trace import profiled
from port_bench.reference import stylegan2 as reference


class ForwardRows:
    """Span of the calls into the model layer: the rows of every forward
    the stream dispatches, recorded around each network's
    `device_images_generic` (traced runs only)."""

    def __init__(self, networks: List[Any]) -> None:
        self.rows: List[int] = []
        for net in networks:
            inner = net.device_images_generic

            def wrapped(batch: np.ndarray, inner: Any = inner) -> Any:
                self.rows.append(int(np.asarray(batch).shape[0]))
                return inner(batch)

            net.device_images_generic = wrapped


def stream_buckets(batch: int) -> List[int]:
    """The batch shapes synthesize_stream can dispatch: full batches and
    remainders padded to powers of two (`_bucket_size` with multiple 1)."""
    sizes, size = [], 1
    while size < batch:
        sizes.append(size)
        size *= 2
    return sizes + [batch]


def run(cell: Any, seed: int, seconds: float, trace: bool, device: Any) -> Outcome:
    mix, config = cell.traffic, cell.config
    program.build_kernels(device)
    from gance_tpu_torch.synthesis.runtime import MultiNetwork, SynthesisNetwork

    gconfig = program.generator_config(config)
    params = [weights.generator_params(config, seed, device, stream=k)
              for k in range(mix["networks"])]
    nets = [SynthesisNetwork(params=p, config=gconfig, truncation_psi=config["truncation_psi"],
                             compute_dtype=torch.float32, device=device) for p in params]
    multi = MultiNetwork.from_networks(nets)
    batch, lookahead = mix["batch"], mix["lookahead"]

    total = int(np.ceil(seconds * mix["max_frames_per_s"]))
    z = traffic.z_rows(total, config["latent_size"], seed)
    indices = traffic.switching_indices(total, mix["networks"], mix["mean_run_frames"],
                                        mix["shape_seed"], mix["block_frames"])

    # set-up: every batch shape the stream can dispatch, on every network,
    # then two windows of the stream itself
    warm = traffic.z_rows(2 * batch * lookahead, config["latent_size"], seed, stream=5)
    for net in nets:
        for rows in stream_buckets(batch):
            net.images_from_vectors(warm[:rows])
    warm_indices = np.arange(len(warm)) * len(nets) // len(warm)
    for _ in multi.synthesize_stream(warm, warm_indices, batch_size=batch, lookahead=lookahead):
        pass
    program.synchronize(device)

    recorder = ForwardRows(nets) if trace else None
    kept = Reservoir(mix["sample_frames"], traffic.rng(seed, 6))
    count = 0
    with profiled(trace, lambda: program.synchronize(device)) as holder:
        window_start = time.perf_counter()
        stream = multi.synthesize_stream(z, indices, batch_size=batch, lookahead=lookahead)
        now = window_start
        for frame in stream:
            kept.offer(count, frame)
            count += 1
            now = time.perf_counter()
            if now - window_start >= seconds:
                break
        stream.close()
    window_s = now - window_start
    if count >= total:
        raise RuntimeError(f"the window consumed all {total} frames of the mix before "
                           f"{seconds} s: raise max_frames_per_s")
    program.synchronize(device)
    peak = program.memory_peak(device)
    forward_rows = recorder.rows if recorder else []
    del stream, multi, nets, recorder
    program.free(device)

    # the reference, once the program's state is freed: the sampled frames
    # from their z through the network their index names
    got, want = [], []
    for k in range(mix["networks"]):
        positions = [p for p, _ in kept.items if indices[p] == k]
        if not positions:
            continue
        z_k = torch.from_numpy(z[positions]).to(device)
        frames = reference.frames_from_z(params[k], z_k, config).cpu().numpy()
        got += [f for p, f in kept.items if indices[p] == k]
        want += list(frames)
    from port_bench.harness.compare import frame_numbers

    numbers = frame_numbers(got, want)
    return Outcome(
        window_start=window_start,
        e2e={"frames_per_s": count / window_s},
        attempted=count, failed=0, numbers=numbers, memory_peak_bytes=peak,
        layer={"trace": holder["trace"], "config": config, "mix": mix,
               "frames": count, "window_s": window_s, "forward_rows": forward_rows},
    )
