"""
Kind `render_stylegan3`: kind `render`'s stream over StyleGAN3 networks.

The window drives `MultiNetwork.synthesize_stream` (synthesis/runtime.py)
over the mix's networks, each a `SynthesisNetwork` of the program's
`StyleGAN3Config` (models/stylegan3.py), one z a frame, network indices
taking turns in runs of geometric length, at the mix's batch and lookahead.
Frames are consumed on the host as they come and kept only in a sample; the
sample is compared with the plain reference (reference/stylegan3.py) once
the program's state is freed. The weights are harness/weights_sg3.py's.

Mix keys: those of kind `render` (kinds/render.py), whose batch buckets and
span of the forwards' rows this kind takes from it. A program without
`models/stylegan3.py` fails at once, before any kernel is built.
"""

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from port_bench.harness import manifest, program, traffic, weights_sg3
from port_bench.harness.compare import frame_numbers
from port_bench.harness.result import Outcome, Reservoir
from port_bench.harness.trace import profiled
from port_bench.reference import stylegan3 as reference

render = manifest.kind_module("render")


def generator_config(config: Dict[str, Any]) -> Any:
    """The program's StyleGAN3Config of a configuration file."""
    from gance_tpu_torch.models.stylegan3 import StyleGAN3Config

    return StyleGAN3Config(**{f.name: config[f.name] for f in dataclasses.fields(StyleGAN3Config)})


def run(cell: Any, seed: int, seconds: float, trace: bool, device: Any) -> Outcome:
    mix, config = cell.traffic, cell.config
    gconfig = generator_config(config)
    program.build_kernels(device)
    from gance_tpu_torch.synthesis.runtime import MultiNetwork, SynthesisNetwork

    params = [weights_sg3.generator_params(config, seed, device, stream=k)
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
        for rows in render.stream_buckets(batch):
            net.images_from_vectors(warm[:rows])
    warm_indices = np.arange(len(warm)) * len(nets) // len(warm)
    for _ in multi.synthesize_stream(warm, warm_indices, batch_size=batch, lookahead=lookahead):
        pass
    program.synchronize(device)

    recorder = render.ForwardRows(nets) if trace else None
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

    got, want = [], []
    for k in range(mix["networks"]):
        positions = [p for p, _ in kept.items if indices[p] == k]
        if not positions:
            continue
        z_k = torch.from_numpy(z[positions]).to(device)
        frames = reference.frames_from_z(params[k], z_k, config).cpu().numpy()
        got += [f for p, f in kept.items if indices[p] == k]
        want += list(frames)
    return Outcome(
        window_start=window_start,
        e2e={"frames_per_s": count / window_s},
        attempted=count, failed=0, numbers=frame_numbers(got, want), memory_peak_bytes=peak,
        layer={"trace": holder["trace"], "config": config, "mix": mix,
               "frames": count, "window_s": window_s, "forward_rows": forward_rows},
    )
