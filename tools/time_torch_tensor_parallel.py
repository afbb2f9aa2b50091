#!/usr/bin/env python3
"""
The port's tensor-parallel 'model' axis over distinct GPUs: `chip_smoke.py`
phase 15a and 15b on four cards of one host, with model 2 x data 2.

    python3 tools/time_torch_tensor_parallel.py          # on a host with 4 GPUs

(a) In one process, `SynthesisNetwork(mesh=create_mesh(data_parallel=2))`
over the four cards: data rows (cuda:0, cuda:1) and (cuda:2, cuda:3), each
sharded layer run on both cards of its row, each replicated one on the
row's first. z and w+ at batch 8 (two rows of 4), fp32 and bf16, the phase
path off and on: fp32 frames within 1 uint8 step on >= 99.9% of one card's,
launches as the sharding table gives them (`chip_smoke.py`'s
`tp_forward_launches`, per row), and ms per batch and frames/s against one
card (CUDA events on every card, the median of `--repeats` calls).

(b) Two processes joined over NCCL, each owning two cards (rank 0 cuda:0-1,
rank 1 cuda:2-3; `initialize_distributed(local_device_ids=...)`), one data
row of model 2 each: `chip_smoke.py` 14b's fp32 train step at a global
batch of 4 (step 0, R1 and PL, deterministic cuDNN), each rank handing in
its rows of the reals. Its losses within 1e-3 relative and its first Adam
moments (the step's gradients) within phase 7a's bounds of the same step on
one card; the seconds of each rank's step and the peak memory of each of
its cards.

(c) The per-network and data-parallel placements over the four cards in one
process, one network per card and the data axis alone: 40 frames of two
networks within 1 step on 99.9% of one card's stream (their slots on cards
1-3 launch kernels while card 0 is current).

Prints the cards' names and power limits first. Needs four CUDA devices;
exits 1 with fewer. Writes nothing outside a temporary directory of the
repository.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    BATCH,
    DIST_BATCH,
    DIST_TRAIN,
    SEED,
    check_frames,
    dist_inputs,
    dist_reference_train,
    fail,
    free_port,
    require,
    require_close_frames,
    require_losses_close,
    require_moments_close,
    set_phase,
    smoke_params,
    tp_forward_launches,
)


def timed_ms(fn, repeats: int) -> float:
    """Median ms of `repeats` calls, CUDA events on every card around each."""
    samples = []
    for _ in range(repeats):
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        begin = time.perf_counter()
        fn()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        samples.append(1e3 * (time.perf_counter() - begin))
    return float(np.median(samples))


def synthesis_part(config, path: Path, repeats: int) -> None:
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts
    from gance_tpu_torch.parallel.mesh import create_mesh
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    rng = np.random.RandomState(SEED + 160)
    z = rng.standard_normal((BATCH, config.latent_size)).astype(np.float32)
    w = rng.standard_normal((BATCH, config.num_style_rows, config.dlatent_size)).astype(np.float32)
    mesh = create_mesh(data_parallel=2)
    require(mesh.shape == {"data": 2, "model": 2} and len(mesh.local_devices) == 4,
            f"mesh {mesh.shape} over {mesh.local_devices}")
    staged = SynthesisNetwork.stage_pkl(path)
    for dtype in ("float32", "bfloat16"):
        single = SynthesisNetwork.from_staged(staged, path, device="cuda:0",
                                              compute_dtype=getattr(torch, dtype))
        net = SynthesisNetwork.from_staged(staged, path, mesh=mesh,
                                           compute_dtype=getattr(torch, dtype))
        for phase in (False, True):
            set_phase("on" if phase else "off")
            for kind, x in (("vectors", z), ("matrices", w)):
                request = getattr(net, f"images_from_{kind}")
                reset_launch_counts()
                got = request(x)
                want = {k: 2 * sum(s[k] for s in tp_forward_launches(config, 2, phase))
                        for k in LAUNCHES}
                label = f"(a) {dtype} {kind} phase {'on' if phase else 'off'}"
                require(dict(LAUNCHES) == want, f"{label}: launches {dict(LAUNCHES)} != {want}")
                check_frames(label, got, BATCH, config.resolution)
                direct = getattr(single, f"images_from_{kind}")(x)
                if dtype == "float32":
                    require_close_frames(f"{label} over 4 cards vs one card", got, direct)
            mesh_ms = timed_ms(lambda: net.images_from_vectors(z), repeats)
            one_ms = timed_ms(lambda: single.images_from_vectors(z), repeats)
            print(f"(a) {dtype} phase {'on' if phase else 'off'}: model 2 x data 2 over four "
                  f"cards {mesh_ms:.3f} ms per batch of 8 ({1e3 * BATCH / mesh_ms:.2f} frames/s); "
                  f"one card {one_ms:.3f} ms ({1e3 * BATCH / one_ms:.2f} frames/s)", flush=True)
        del single, net
        torch.cuda.empty_cache()
    set_phase("off")


def placement_part(config, workdir: Path) -> None:
    """(c): the per-network and data-parallel placements over the four cards
    in one process, whose slots on cards 1-3 launch kernels while card 0 is
    current: one network per card (`device_per_network`) and the data axis
    alone, 40 frames of two networks against one card's stream."""
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.parallel.mesh import create_mesh
    from gance_tpu_torch.synthesis.runtime import MultiNetwork

    paths = [workdir / "0_net.pkl", workdir / "1_net.pkl"]
    save_generator_pickle(smoke_params(SEED + 10, config), paths[1])
    frames = np.random.RandomState(SEED + 161).standard_normal(
        (40, config.latent_size)).astype(np.float32)
    indices = np.arange(40) % 2
    with MultiNetwork(paths, device="cuda:0") as plain:
        want = plain.synthesize_all(frames, indices)
    for label, options in (("one network per card", dict(device_per_network=True)),
                           ("data 4", dict(mesh=create_mesh()))):
        with MultiNetwork(paths, device="cuda", **options) as placed:
            got = placed.synthesize_all(frames, indices)
        require_close_frames(f"(c) {label} over four cards vs one card", got, want)


def child(spec: dict) -> None:
    """(b): one rank of two, owning two cards."""
    import torch.distributed as dist

    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops.precision import deterministic_cudnn
    from gance_tpu_torch.parallel import training as T
    from gance_tpu_torch.parallel.distributed import global_batch, initialize_distributed
    from gance_tpu_torch.parallel.mesh import create_mesh, process_rows

    rank, config = spec["rank"], GeneratorConfig()
    cards = [2 * rank, 2 * rank + 1]
    backend = initialize_distributed(f"localhost:{spec['port']}", 2, rank, device="cuda",
                                     local_device_ids=cards)
    mesh = create_mesh(data_parallel=2, device="cuda")
    tc = T.TrainingConfig(**DIST_TRAIN)
    reals, draws, _ = dist_inputs(config, tc)
    state = T.shard_training_state(mesh, T.init_training_state(SEED + 141, config, tc, "cuda"),
                                   tc)
    step = T.make_train_step(config, tc, mesh)
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    mine = reals[0][process_rows(mesh, DIST_BATCH)]
    for card in cards:
        torch.cuda.synchronize(card)
    begin = time.perf_counter()
    with deterministic_cudnn():
        state, metrics = step(state, global_batch(mesh, mine), draws[0])
    for card in cards:
        torch.cuda.synchronize(card)
    out = {"backend": backend, "mesh": mesh.shape, "seconds": time.perf_counter() - begin,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "peak_gib": [torch.cuda.max_memory_allocated(c) / 2**30 for c in cards],
           "moments": {net: T._adam_to_numpy(getattr(state, f"{net}_opt_state"),
                                             getattr(state, f"{net}_params"))["mu"]
                       for net in ("g", "d")} if rank == 0 else None}
    with open(Path(spec["workdir"]) / f"tp4_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def training_part(config, workdir: Path) -> None:
    tc_args = dict(DIST_TRAIN)
    port = free_port()
    code = ("import json, sys; sys.path.insert(0, 'tools'); import time_torch_tensor_parallel "
            "as t; t.child(json.loads(sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [workdir / f"tp4_{rank}.log" for rank in range(2)]
    children = []
    for rank in range(2):
        spec = {"rank": rank, "port": port, "workdir": str(workdir)}
        with open(logs[rank], "wb") as log:
            children.append(subprocess.Popen([sys.executable, "-c", code, json.dumps(spec)],
                                             cwd=ROOT, env=env, stdout=log,
                                             stderr=subprocess.STDOUT))
    try:
        for rank, c in enumerate(children):
            code_ = c.wait(timeout=900)
            require(code_ == 0, f"(b) rank {rank} exited {code_}:\n"
                    f"{logs[rank].read_text(errors='replace')[-4000:]}")
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    outs = []
    for rank in range(2):
        with open(workdir / f"tp4_{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    from gance_tpu_torch.parallel import training as T

    begin = time.perf_counter()
    metrics, _, moments = dist_reference_train(config, T.TrainingConfig(**tc_args), steps=1)
    one_s = time.perf_counter() - begin
    for rank, out in enumerate(outs):
        require(out["backend"] == "nccl" and out["mesh"] == {"data": 2, "model": 2},
                f"(b) rank {rank}: {out['backend']}, mesh {out['mesh']}")
        require_losses_close(f"(b) rank {rank} step 0", out["metrics"], metrics[0])
    require_moments_close("(b) step 0", outs[0]["moments"], moments[0],
                          "model 2 x data 2 over NCCL vs one card")
    print(f"(b) fp32 train step 0 (R1 and PL, global batch {DIST_BATCH}, deterministic cuDNN), "
          f"two NCCL ranks of two cards each: rank steps {outs[0]['seconds']:.3f} and "
          f"{outs[1]['seconds']:.3f} s (the first step in each process), peak GiB per card "
          f"{[round(g, 2) for o in outs for g in o['peak_gib']]}; one card's step (its first, "
          f"setup included) {one_s:.3f} s; losses {outs[0]['metrics']} vs one card {metrics[0]}",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        fail(f"needs 4 CUDA devices, found {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops.cuda import build

    print(f"kernel build: {build.build_all():.1f} s", flush=True)
    config = GeneratorConfig()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        workdir = Path(tmp)
        save_generator_pickle(smoke_params(SEED, config), workdir / "0_net.pkl")
        synthesis_part(config, workdir / "0_net.pkl", args.repeats)
        torch.cuda.empty_cache()
        placement_part(config, workdir)
        torch.cuda.empty_cache()
        training_part(config, workdir)
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}))


if __name__ == "__main__":
    main()
