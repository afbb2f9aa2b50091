"""
The port's metrics entry points against gance_tpu's, on the CPU:

  * `python -m gance_tpu_torch.cli.network_metrics ppl|frechet` against
    gance_tpu/cli/network_metrics.py on the same .pkl (tests/test_metrics.py's
    32px MODEL): the same JSON keys and, with JAX's draws handed to the port's
    metrics (its default draws patched), values within tests/test_torch_metrics.py's
    tolerances (PPL at epsilon 1e-2: 2e-4 relative);
  * `evaluate_training_metrics` against JAX's on the same network and draws,
    and `append_metrics_record`;
  * `cli/train.py --metrics-every` writes JAX's record keys, with
    `--scan-segment` and `--remat`, and `--run-config` dumps the new options;
  * a `run_training` with a metrics evaluation equals one without, bit for bit.

The Fréchet CLI runs all 1472 feature dims; the other evaluations take VGG
blocks 0-1 (192 dims, `two_block_features`), as scipy's sqrtm of a
1472-dim product takes seconds on each call.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from gance_tpu.cli import network_metrics as jax_cli  # noqa: E402
from gance_tpu.metrics import training_eval as jax_eval  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.projection.lpips import random_vgg_params  # noqa: E402
from gance_tpu_torch.cli import network_metrics as port_cli  # noqa: E402
from gance_tpu_torch.metrics import frechet as port_frechet  # noqa: E402
from gance_tpu_torch.metrics import ppl as port_ppl  # noqa: E402
from gance_tpu_torch.metrics import training_eval as port_eval  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.parallel import training as T  # noqa: E402
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402
from tests.test_torch_metrics import two_block_features  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

MODEL_KW = dict(resolution=32, fmap_base=256, fmap_max=32, latent_size=32, dlatent_size=32,
                mapping_layers=2, mapping_fmaps=32)
JAX_MODEL = jax_g.GeneratorConfig(**MODEL_KW)
TRAIN_KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
                mapping_layers=2, mapping_fmaps=16)
RECORD_KEYS = ["step", "ppl_w_full", "frechet_feature_distance", "num_samples", "feature_dim",
               "eval_seconds"]


def jax_draws_patch(monkeypatch):
    """Route the port's default draws to JAX's threefry draws of the same
    seed, chunk by chunk (gance_tpu/metrics/ppl.py:99-103, frechet.py:148)."""

    def pair_draws(seed, latent_size, sampling):
        def draw(chunk, batch):
            z_key, t_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), chunk))
            z = np.asarray(jax.random.normal(z_key, (batch * 2, latent_size)))
            if sampling == "full":
                return z, np.asarray(jax.random.uniform(t_key, (batch, 1)))
            return z, np.zeros((batch, 1), np.float32)

        return draw

    def latent_draws(seed, latent_size):
        def draw(chunk, batch):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), chunk)
            return np.asarray(jax.random.normal(key, (batch, latent_size)))

        return draw

    monkeypatch.setattr(port_ppl, "default_pair_draws", pair_draws)
    monkeypatch.setattr(port_frechet, "default_latent_draws", latent_draws)


@pytest.fixture(scope="module")
def jax_network():
    return jax_g.init_generator_params(jax.random.PRNGKey(0), JAX_MODEL)


@pytest.fixture(scope="module")
def network_pkl(tmp_path_factory, jax_network):
    path = tmp_path_factory.mktemp("metrics") / "net.pkl"
    save_generator_pickle(jax_network, path)
    return path


def _images(path, count, side, seed):
    from PIL import Image

    path.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(count):
        Image.fromarray(rng.randint(0, 255, size=(side, side, 3), dtype=np.uint8)).save(
            path / f"{i:03d}.png")
    return path


def _last_json(result):
    assert result.exit_code == 0, result.output
    return json.loads(result.output.strip().splitlines()[-1])


@pytest.mark.parametrize("space", ["w", "z"])
def test_ppl_cli_matches_jax(monkeypatch, network_pkl, space):
    jax_draws_patch(monkeypatch)
    args = ["ppl", "--network", str(network_pkl), "--num-samples", "4", "--batch-size", "4",
            "--epsilon", "1e-2", "--space", space, "--seed", "3"]
    want = _last_json(CliRunner().invoke(jax_cli.cli, args, catch_exceptions=False))
    got = _last_json(CliRunner().invoke(port_cli.cli, args + ["--device", "cpu"],
                                        catch_exceptions=False))
    assert list(got) == list(want)
    assert got["metric"] == f"ppl_{space}_full" and got["perceptual"] == "random-vgg"
    assert got["value"] == pytest.approx(want["value"], rel=2e-4)
    assert {k: v for k, v in got.items() if k != "value"} == {
        k: v for k, v in want.items() if k != "value"}


def test_frechet_cli_matches_jax(monkeypatch, network_pkl, tmp_path):
    jax_draws_patch(monkeypatch)
    real = _images(tmp_path / "real", 6, 32, 5)
    args = ["frechet", "--network", str(network_pkl), "--dataset-directory", str(real),
            "--num-samples", "6", "--batch-size", "4"]
    want = _last_json(CliRunner().invoke(jax_cli.cli, args, catch_exceptions=False))
    got = _last_json(CliRunner().invoke(port_cli.cli, args + ["--device", "cpu"],
                                        catch_exceptions=False))
    assert list(got) == list(want)
    assert got["feature_dim"] == 1472 and got["num_fake"] == got["num_real"] == 6
    # features within 1e-5 (tests/test_torch_metrics.py); the rank-deficient
    # sqrtm amplifies that to 4.9e-6 relative here
    assert got["value"] == pytest.approx(want["value"], rel=1e-4)
    assert {k: v for k, v in got.items() if k != "value"} == {
        k: v for k, v in want.items() if k != "value"}


def test_cli_default_device_is_cuda(monkeypatch, network_pkl):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = CliRunner().invoke(port_cli.cli, ["ppl", "--network", str(network_pkl),
                                               "--num-samples", "2"])
    assert result.exit_code != 0 and "device='cpu'" in str(result.exception)


def test_evaluate_training_metrics_matches_jax(monkeypatch, jax_network, tmp_path):
    """The record against JAX's on JAX's draws, with VGG blocks 0-1 as both
    packages' features (`two_block_features`; the CLI test keeps all 1472)."""
    jax_draws_patch(monkeypatch)
    two_block_features(monkeypatch)
    real = _images(tmp_path / "real", 8, 32, 7)
    perceptual = random_vgg_params(seed=0)
    want = jax_eval.evaluate_training_metrics(jax_network, JAX_MODEL, perceptual, real, step=6,
                                              num_samples=8, batch_size=4, seed=2)
    ema = params_to_device(params_from_reference(jax_network), torch.device("cpu"))
    got = port_eval.evaluate_training_metrics(ema, port_g.GeneratorConfig(**MODEL_KW),
                                              perceptual, real, step=6, num_samples=8,
                                              batch_size=4, seed=2)
    assert list(got) == list(want) == RECORD_KEYS
    # the default epsilon 1e-4: tests/test_torch_metrics.py's 1e-2 relative
    assert got["ppl_w_full"] == pytest.approx(want["ppl_w_full"], rel=1e-2)
    assert got["frechet_feature_distance"] == pytest.approx(want["frechet_feature_distance"],
                                                            rel=1e-4)
    for key in ("step", "num_samples", "feature_dim"):
        assert got[key] == want[key]
    assert got["feature_dim"] == 192
    path = tmp_path / "deep" / "m.jsonl"
    port_eval.append_metrics_record(path, {**got, "step": np.int64(6)})
    port_eval.append_metrics_record(None, got)
    assert json.loads(path.read_text().splitlines()[0]) == got


def _train_args(data, tmp_path, steps):
    return ["--dataset-directory", str(data), "--resolution", "16", "--batch-size", "4",
            "--fmap-base", "256", "--fmap-max", "32", "--latent-size", "16",
            "--checkpoint-path", str(tmp_path / "ckpt.pkl"), "--checkpoint-every", "2",
            "--output-network", str(tmp_path / "net.pkl"), "--device", "cpu",
            "--total-steps", str(steps)]


def test_train_cli_metrics_every_writes_jax_records(monkeypatch, tmp_path):
    """4 steps, checkpoints at 2 and 4, --metrics-every 2: two records with
    JAX's keys in the default sidecar, finite values; a resume to 6 without
    it adds none. --run-config dumps the new options with JAX's defaults
    where not given. Features: VGG blocks 0-1 (`two_block_features`)."""
    from gance_tpu_torch.cli.train import cli

    two_block_features(monkeypatch)
    data = _images(tmp_path / "data", 6, 16, 0)
    run_config = tmp_path / "run.json"
    args = _train_args(data, tmp_path, 4) + ["--metrics-every", "2", "--metrics-samples", "4",
                                             "--scan-segment", "2", "--remat",
                                             "--run-config", str(run_config)]
    assert CliRunner().invoke(cli, args, catch_exceptions=False).exit_code == 0
    sidecar = tmp_path / "ckpt.pkl.metrics.jsonl"
    records = [json.loads(line) for line in sidecar.read_text().splitlines()]
    assert [r["step"] for r in records] == [2, 4]
    for record in records:
        assert list(record) == RECORD_KEYS
        assert all(np.isfinite(record[k]) for k in RECORD_KEYS)
        assert record["num_samples"] == 4 and record["feature_dim"] == 192
    dumped = json.loads(run_config.read_text())
    assert dumped["remat"] is True and dumped["scan_segment"] == 2
    assert dumped["metrics_every"] == 2 and dumped["metrics_samples"] == 4
    assert dumped["metrics_path"] is None and dumped["metrics_vgg_weights"] is None
    # a resume without --metrics-every leaves the sidecar as it was
    assert CliRunner().invoke(cli, _train_args(data, tmp_path, 6),
                              catch_exceptions=False).exit_code == 0
    assert [json.loads(line)["step"] for line in sidecar.read_text().splitlines()] == [2, 4]
    assert T.load_checkpoint(tmp_path / "ckpt.pkl", device="cpu").step == 6


def test_metrics_every_counts_from_the_run_start(monkeypatch, tmp_path):
    """--metrics-every 4 with checkpoints every 2, resumed at step 2: the first
    evaluation comes at step 6 (4 steps after the start), as in JAX's loop."""
    from gance_tpu_torch.cli.train import cli

    two_block_features(monkeypatch)
    data = _images(tmp_path / "data", 6, 16, 0)
    metrics_path = tmp_path / "curve.jsonl"
    extra = ["--metrics-every", "4", "--metrics-samples", "2", "--metrics-path",
             str(metrics_path)]
    assert CliRunner().invoke(cli, _train_args(data, tmp_path, 2),
                              catch_exceptions=False).exit_code == 0
    assert CliRunner().invoke(cli, _train_args(data, tmp_path, 6) + extra,
                              catch_exceptions=False).exit_code == 0
    assert [json.loads(line)["step"] for line in metrics_path.read_text().splitlines()] == [6]


def test_run_training_with_metrics_equals_without(monkeypatch, tmp_path):
    two_block_features(monkeypatch)
    config = port_g.GeneratorConfig(**TRAIN_KW)
    tc = T.TrainingConfig(r1_interval=2, pl_interval=2)
    data_dir = _images(tmp_path / "data", 6, 16, 0)
    from gance_tpu_torch.parallel.data import StreamingImageDataset

    perceptual = random_vgg_params(seed=0)
    records = []

    def hook(step, state):
        if step == 2:  # mid-run, so that steps 3 and 4 follow an evaluation
            records.append(port_eval.evaluate_training_metrics(
                state.ema_params, config, perceptual, data_dir, step, num_samples=4,
                batch_size=2))

    states = [T.run_training(StreamingImageDataset(data_dir, 16, seed=1), config, tc,
                             tmp_path / f"{name}.ckpt", 4, 4, checkpoint_every=2, seed=0,
                             device="cpu", metrics_hook=metrics_hook)
              for name, metrics_hook in (("plain", None), ("metrics", hook))]
    assert [r["step"] for r in records] == [2]
    a, b = states
    assert a.step == b.step == 4 and torch.equal(a.pl_mean, b.pl_mean)
    for which in ("g_params", "d_params", "ema_params"):
        for (p, x), (_, y) in zip(T.tree_leaves(getattr(a, which)),
                                  T.tree_leaves(getattr(b, which))):
            assert torch.equal(x, y), (which, p)
