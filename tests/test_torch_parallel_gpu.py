"""
Two processes on one CUDA GPU (marker `gpu`; skips without CUDA): the
counterpart of `chip_smoke.py` 14b's synthesis check. Two ranks share the
card, so `initialize_distributed` picks gloo (NCCL refuses two ranks on one
device); each rank synthesizes its half of every batch with the CUDA
kernels and every rank gets all frames, within 1 uint8 step on 99.9% of
the values of one process synthesizing the same shards. Imports no jax:

    python3 -m pytest --noconftest tests/test_torch_parallel_gpu.py -m gpu -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from gance_tpu_torch.parallel.network_parallel import (  # noqa: E402
    NetworkParallelSynthesis,
    create_network_mesh,
)
from gance_tpu_torch.parallel.sharded_synthesis import make_sharded_synthesis  # noqa: E402
from gance_tpu_torch.synthesis.runtime import SynthesisNetwork  # noqa: E402
from tests.torch_parallel_worker import run_workers  # noqa: E402

KW = dict(resolution=32, fmap_base=1024, fmap_max=128, latent_size=32, dlatent_size=32,
          mapping_layers=2, mapping_fmaps=32)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def assert_most_within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    steps = np.abs(got.astype(int) - want.astype(int))
    assert int(steps.max()) <= 1 and float(np.mean(steps == 0)) >= 0.999


@pytest.mark.gpu
def test_two_ranks_on_one_gpu_synthesize_one_process_frames(cuda_device, tmp_path):
    config = port_g.GeneratorConfig(**KW)
    params = [port_g.init_generator_params(seed, config) for seed in (1, 2)]
    rng = np.random.RandomState(3)
    inputs = dict(config=KW, params=params, device="cuda",
                  z=rng.randn(8, 32).astype(np.float32),
                  w=rng.randn(6, config.num_style_rows, 32).astype(np.float32),
                  indices=np.array([0, 1, 1, 0, 1, 1, 0, 0]))
    outs = run_workers("synthesis", inputs, tmp_path, world=2, timeout=600)
    two = [cuda_device] * 2
    mesh = create_mesh(devices=two)
    want = dict(
        sharded=make_sharded_synthesis(mesh, params[0], config)(inputs["z"]),
        matrices=SynthesisNetwork(params=params[0], config=config, mesh=mesh)
        .images_from_matrices(inputs["w"]),
        network_parallel=NetworkParallelSynthesis(
            params, config, mesh=create_network_mesh(2, devices=two))
        .synthesize(inputs["z"], inputs["indices"], batch_size=2),
    )
    for out in outs:
        assert out["backend"] == "gloo"
        for key, frames in want.items():
            assert_most_within_one_step(out[key], frames)
