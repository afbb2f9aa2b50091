"""
One rank of the port's multi-process tests: joins a gloo group of `world`
CPU processes and runs one task on the inputs the test pickled, writing its
results for the test to compare. Imports torch and the port only, never JAX.

    python -m tests.torch_parallel_worker TASK RANK WORLD PORT DIR [SLOTS]

DIR/inputs.pkl holds the task's inputs; the rank writes DIR/out_RANK.pkl.
SLOTS (default 1) is how many mesh slots the rank's CPU gives (`cpu_slots`).
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

# one thread in the ranks, and in every pytest worker that collects a test
# module importing this one: six workers share the host's cores, and torch
# would otherwise start one spinning thread per core in each
torch.set_num_threads(1)


def cpu_slots(count: int, monkeypatch=None) -> None:
    """Give the CPU `count` mesh slots, as the JAX tests have virtual CPU
    devices: `gance_tpu_torch.parallel.mesh.local_devices("cpu")`, which
    `create_mesh(device="cpu")` and the placements read, then names the CPU
    `count` times. Through `monkeypatch` when given (undone after the test),
    else for the rest of the process."""
    from gance_tpu_torch.parallel import mesh

    real = mesh.local_devices

    def local_devices(device="cuda"):
        if torch.device(device).type == "cpu":
            return [torch.device("cpu")] * count
        return real(device)

    if monkeypatch is None:
        mesh.local_devices = local_devices
    else:
        monkeypatch.setattr(mesh, "local_devices", local_devices)


def task_mbstd(rank, world, inputs):
    """Minibatch stddev of each rank's contiguous rows over the whole batch,
    and the input gradient of sum(out * weights)."""
    from gance_tpu_torch.models.stylegan2 import minibatch_stddev
    from gance_tpu_torch.parallel.training import _GatherRows

    x, weights, group = inputs["x"], inputs["weights"], inputs["group"]
    per = x.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    local = torch.from_numpy(x[rows]).requires_grad_(True)
    full = _GatherRows.apply(local, x.shape[0], rows.start)
    out = minibatch_stddev(local, group, 1, full, rows.start)
    (out * torch.from_numpy(weights[rows])).sum().backward()
    return {"values": out.detach().numpy(), "grads": local.grad.numpy()}


def task_synthesis(rank, world, inputs):
    """Sharded and network-parallel synthesis over every process's CPU slots,
    and the re-init checks of initialize_distributed."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel import distributed
    from gance_tpu_torch.parallel.mesh import create_mesh
    from gance_tpu_torch.parallel.network_parallel import NetworkParallelSynthesis
    from gance_tpu_torch.parallel.sharded_synthesis import make_sharded_synthesis
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    device = inputs.get("device", "cpu")
    again = distributed.initialize_distributed(*inputs["triple"][rank], device=device)
    try:
        distributed.initialize_distributed("localhost:1", world, rank, device=device)
        conflict = None
    except RuntimeError as error:
        conflict = str(error)
    config = GeneratorConfig(**inputs["config"])
    mesh = create_mesh(device=device)
    sharded = make_sharded_synthesis(mesh, inputs["params"][0], config)(inputs["z"])
    network = SynthesisNetwork(params=inputs["params"][0], config=config, mesh=mesh)
    frames = network.images_from_matrices(inputs["w"])
    serving = NetworkParallelSynthesis(inputs["params"], config, device=device)
    streamed = serving.synthesize(inputs["z"], inputs["indices"], batch_size=2)
    return {"backend": again, "conflict": conflict, "mesh": mesh.shape,
            "sharded": sharded, "matrices": frames, "network_parallel": streamed,
            "network_mesh": serving.mesh.shape}


def task_train(rank, world, inputs):
    """`steps` data-parallel train steps over every process's CPU slots,
    each process handing in only its rows of the reals."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel import training as T
    from gance_tpu_torch.parallel.distributed import global_batch
    from gance_tpu_torch.parallel.mesh import create_mesh, process_rows

    if inputs.get("min_sharded"):
        from gance_tpu_torch.parallel import mesh as port_mesh

        port_mesh._MIN_SHARDED_PARAM = inputs["min_sharded"]
    if inputs.get("reduce_bucket_bytes"):
        T._REDUCE_BUCKET_BYTES = inputs["reduce_bucket_bytes"]
    config = GeneratorConfig(**inputs["config"])
    tc = T.TrainingConfig(**inputs["train_config"])
    mesh = create_mesh(device="cpu", data_parallel=inputs.get("data_parallel"))
    state = T.training_state_from_arrays(*inputs["state"], train_config=tc, device="cpu")
    if rank:  # process 0's state is everyone's start
        state = T.init_training_state(99, config, tc, "cpu")
    state = T.shard_training_state(mesh, state, tc)
    step = T.make_train_step(config, tc, mesh)
    metrics = []
    for reals, draws in zip(inputs["reals"], inputs["draws"]):
        mine = reals[process_rows(mesh, reals.shape[0])]
        state, m = step(state, global_batch(mesh, mine), draws)
        metrics.append({k: float(v) for k, v in m.items()})
    T.save_checkpoint(Path(inputs["dir"]) / f"ckpt_{rank}.pkl", state)  # process 0 writes
    shared = None
    if hasattr(state.g_params, "slots"):  # a model group: each replicated leaf is one tensor
        from gance_tpu_torch.parallel.tensor_parallel import _get, _paths

        shared = [all(_get(slot, path) is _get(tree.slots[0], path) for slot in tree.slots)
                  for tree in (state.g_params, state.d_params, state.ema_params)
                  for path, dim in _paths(tree.spec) if dim is None]
    return {"metrics": metrics, "g": T.tree_to_numpy(state.g_params), "shared": shared,
            "mesh": mesh.shape,
            "d": T.tree_to_numpy(state.d_params), "ema": T.tree_to_numpy(state.ema_params),
            "pl_mean": float(state.pl_mean), "step": state.step,
            "g_adam": T._adam_to_numpy(state.g_opt_state, state.g_params)}


def task_project(rank, world, inputs):
    """A data-parallel projection of the whole batch over every process's CPU slots."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel.mesh import create_mesh
    from gance_tpu_torch.projection.projector import Projector, ProjectorSettings

    steps = []
    projector = Projector(inputs["params"], GeneratorConfig(**inputs["config"]),
                          settings=ProjectorSettings(**inputs["settings"]),
                          mesh=create_mesh(device="cpu"), device="cpu")
    results = projector.project_batch(
        inputs["targets"], step_callback=lambda s, lat, *_: steps.append(lat[:, 0].copy()),
        want_step_images=False, per_step_noises=False, **inputs["start"])
    return {"steps": np.stack(steps), "latents": np.stack([r.final_latents for r in results]),
            "distances": np.array([r.final_distance for r in results]),
            "noises": [np.concatenate([r.noises[i] for r in results])
                       for i in range(len(results[0].noises))],
            "images": np.stack([r.final_image for r in results])}


def task_project_fail(rank, world, inputs):
    """A distributed project_video_to_file whose coordinator's writer fails
    on its first frame: every process must exit, none may hang."""
    from gance_tpu_torch.parallel.mesh import create_mesh
    from gance_tpu_torch.projection import file_writer

    class FailingWriter(file_writer.ProjectionFileWriter):
        def record_noises_shapes(self, shapes):
            raise OSError("No space left on device (simulated)")

    file_writer.ProjectionFileWriter = FailingWriter
    file_writer.project_video_to_file(
        Path(inputs["video"]), Path(inputs["network"]), Path(inputs["dir"]) / "p.hdf5",
        steps_per_projection=2, num_frames_to_project=4, projection_batch=2,
        mesh=create_mesh(device="cpu"), device="cpu", expected_time_per_step=600.0)
    return {"finished": True}


def task_daemon(rank, world, inputs):
    """The online daemon over a mesh spanning the processes: rank 0 binds
    HTTP, wraps its networks in the multi-process proxies and sends real
    requests (z, w+, a hot load and a request to the loaded network); the
    other ranks mirror every dispatch through the control channel."""
    from gance_tpu_torch.parallel import mesh as port_mesh
    from gance_tpu_torch.serving.multihost import (
        ControlCoordinator,
        MultiHostNetwork,
        network_fingerprint,
        run_worker,
        wrap_networks_for_multihost,
    )
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    if inputs.get("min_sharded"):
        port_mesh._MIN_SHARDED_PARAM = inputs["min_sharded"]
    workdir = Path(inputs["dir"])
    mesh = port_mesh.create_mesh(data_parallel=inputs.get("data_parallel"), device="cpu")
    network = SynthesisNetwork.from_pkl(workdir / "net.pkl", mesh=mesh, device="cpu")

    def commit(staged, path, _index=0):
        return SynthesisNetwork.from_staged(staged, Path(path), mesh=mesh, device="cpu")

    sharded = 0
    if hasattr(network.params, "spec"):
        from gance_tpu_torch.parallel.training import tree_leaves

        sharded = sum(dim is not None for _, dim in tree_leaves(network.params.spec))
    out = {"mesh": mesh.shape, "sharded": sharded}
    if rank:
        out["served"] = run_worker([network], "127.0.0.1", inputs["control_port"], rank,
                                   recv_timeout_s=300.0,
                                   load_prepare=lambda path, _i: SynthesisNetwork.stage_pkl(
                                       Path(path)),
                                   load_commit=commit)
        return out
    from gance_tpu_torch.serving import ServingClient, SynthesisDaemon

    coordinator = ControlCoordinator(num_workers=world - 1, bind_host="127.0.0.1",
                                     port=inputs["control_port"], heartbeat_interval_s=1.0)
    coordinator.accept(network_fingerprint([network]), timeout_s=300.0)

    def network_loader(path: str, index: int):
        staged = SynthesisNetwork.stage_pkl(Path(path))
        coordinator.broadcast_load(path, index)
        return MultiHostNetwork(commit(staged, path), coordinator, index)

    with SynthesisDaemon(wrap_networks_for_multihost([network], coordinator), port=0,
                         max_batch=8, network_loader=network_loader,
                         network_unloader=coordinator.broadcast_unload) as daemon:
        client = ServingClient(f"http://127.0.0.1:{daemon.port}", timeout_s=300.0)
        assert client.health()["ok"]
        out["out_z"] = client.synthesize(latents=inputs["z"])
        out["out_w"] = client.synthesize(dlatents=inputs["w"])
        loaded = client.load_network(str(workdir / "net2.pkl"))
        assert loaded["index"] == 1 and loaded["name"] == "net2", loaded
        out["out_z2"] = client.synthesize(latents=inputs["z"], network="net2")
        assert client.unload_network("net2")["drained"] is True
    coordinator.shutdown()
    assert not coordinator.failed.is_set(), "control channel failed"
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def child_env() -> dict:
    """The environment of a child process: this repository importable, one
    CPU thread (six test workers share the host's cores)."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    return env


def launch(commands, timeout: float = 300.0):
    """Start one child per command (argument lists) and wait for them all:
    [(returncode, output)], each killed at `timeout` seconds (returncode
    None then)."""
    import subprocess

    root = Path(__file__).resolve().parents[1]
    children = [subprocess.Popen(command, cwd=root, env=child_env(),
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for command in commands]
    results = []
    for child in children:
        try:
            out, _ = child.communicate(timeout=timeout)
            code = child.returncode
        except subprocess.TimeoutExpired:
            for other in children:
                other.kill()
            out, _ = child.communicate()
            code = None
        results.append((code, out.decode(errors="replace")))
    return results


def run_workers(task: str, inputs: dict, directory: Path, world: int = 2,
                cpu_devices: int = 1, timeout: float = 300.0, check: bool = True):
    """Run `task` on `world` gloo ranks of `cpu_devices` CPU slots each over
    `inputs`: each rank's results (check=True, which asserts every rank
    exited 0), else [(returncode, output)]."""
    directory = Path(directory)
    with open(directory / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    results = launch([[sys.executable, "-m", "tests.torch_parallel_worker", task, str(rank),
                       str(world), str(port), str(directory), str(cpu_devices)]
                      for rank in range(world)], timeout)
    if not check:
        return results
    for rank, (code, output) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{output[-4000:]}"
    outs = []
    for rank in range(world):
        with open(directory / f"out_{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def main() -> None:
    task, rank, world, port, directory = sys.argv[1:6]
    rank, world = int(rank), int(world)
    cpu_slots(int(sys.argv[6]) if len(sys.argv) > 6 else 1)
    directory = Path(directory)
    with open(directory / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    from gance_tpu_torch.parallel.distributed import initialize_distributed

    inputs.setdefault("dir", str(directory))
    triple = (f"localhost:{port}", world, rank)
    inputs["triple"] = {rank: triple}
    initialize_distributed(*triple, device=inputs.get("device", "cpu"))
    out = globals()[f"task_{task}"](rank, world, inputs)
    with open(directory / f"out_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    os._exit(0)


if __name__ == "__main__":
    main()
