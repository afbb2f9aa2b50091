"""
The port's training slice (gance_tpu_torch: the downsampling ops, the
discriminator, the trainer, the dataset and the train CLI) against
gance_tpu's, on the CPU.

  * `conv_downsample_2d`, `downsample_2d` and `conv2d_layer(down=True)` at
    the binomial and the (1, 2, 3, 4) FIR, `minibatch_stddev` and
    `discriminator_apply` (16px and 32px tiny configs, the JAX params carried
    over by `discriminator_params_from_reference`), within 1e-4 relative;
  * the discriminator read from an NVlabs-layout pickle by both packages;
  * one whole train step with R1 and path length against
    `gance_tpu.parallel.training._make_train_step_core` (jitted), at
    tests/test_parallel.py's TINY config with r1_interval = pl_interval = 1:
    the state is carried over by `training_state_from_reference` and the
    port's `StepDraws` are rebuilt from the same `jax.random` key, following
    JAX's key derivations. Losses within 1e-4 relative; the gradients (Adam's
    first moment, which is the gradient itself when b1 = 0) within 1e-4 of
    each leaf's largest; every G, D and EMA leaf and `pl_mean` after the step
    within 1e-5 absolute plus 2 fp32 ulps of the value. The Adam caveat: with b1 = 0 the first update is
    lr * g / (|g| + eps), so an element whose gradient is within ~100 eps of
    0 may move by anything up to 2 lr on a gradient difference far below
    fp32 noise; such elements (|JAX update| < 0.99 lr while non-zero) are held
    only to 2 lr, and must be under 1% of a leaf;
  * a train step on the phase path (GANCE_TPU_PHASE1024=on, path length
    differentiating through kernel E's Function twice) against the standard
    path with the same draws, at the 32px golden config: losses within 1e-4
    relative, G's gradients within 1e-3 of each leaf's norm;
  * a bf16 step (finite, losses within 5e-2 relative of fp32), checkpoint
    resume (2 + 2 steps equal 4 bit for bit), the draws, the dataset, and the
    CLI with `--device cpu` (resume, then an export that loads in both
    packages' `load_generator`).
"""

import importlib
import pickle
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.models import pickle_loader as jax_loader  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.parallel import training as jax_training  # noqa: E402
from gance_tpu_torch.models import pickle_loader as port_loader  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import (  # noqa: E402
    discriminator_params_from_reference,
    params_from_reference,
    training_state_from_reference,
)
from gance_tpu_torch.ops import modulated_conv as port_mc  # noqa: E402
from gance_tpu_torch.ops import upfirdn2d as port_fir  # noqa: E402
from gance_tpu_torch.parallel import training as port_training  # noqa: E402
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402

# gance_tpu.ops re-exports functions under these modules' names
jax_fir = importlib.import_module("gance_tpu.ops.upfirdn2d")
jax_mc = importlib.import_module("gance_tpu.ops.modulated_conv")

TINY_KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16,
               dlatent_size=16, mapping_layers=2, mapping_fmaps=16)
D32_KW = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=16,
              dlatent_size=16, mapping_layers=2, mapping_fmaps=16)
BATCH = 4
CPU = torch.device("cpu")
PARAM_ATOL, PARAM_RTOL = 1e-5, 2.0 ** -22


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-12))


# ---------------------------------------------------------------------------
# Ops and the discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fir", [(1, 3, 3, 1), (1, 2, 3, 4)])
@pytest.mark.parametrize("ksize", [3, 1])
def test_conv_downsample_2d_matches_jax(rng, fir, ksize):
    x = rng.randn(2, 10, 10, 5).astype(np.float32)
    w = rng.randn(ksize, ksize, 5, 6).astype(np.float32)
    want = np.asarray(jax_fir.conv_downsample_2d(jnp.asarray(x), jnp.asarray(w), kernel=fir))
    got = port_fir.conv_downsample_2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                      kernel=fir)
    assert_rel(nhwc(got), want, 1e-5)


@pytest.mark.parametrize("fir", [(1, 3, 3, 1), (1, 2, 3, 4)])
def test_downsample_2d_matches_jax(rng, fir):
    x = rng.randn(2, 9, 12, 3).astype(np.float32)
    want = np.asarray(jax_fir.downsample_2d(jnp.asarray(x), kernel=fir))
    assert_rel(nhwc(port_fir.downsample_2d(nchw(x), kernel=fir)), want, 1e-5)


@pytest.mark.parametrize("fir", [(1, 3, 3, 1), (1, 2, 3, 4)])
@pytest.mark.parametrize("mode", ["down", "plain", "up"])
def test_conv2d_layer_matches_jax(rng, fir, mode):
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 6).astype(np.float32)
    flags = dict(up=mode == "up", down=mode == "down")
    want = np.asarray(jax_mc.conv2d_layer(jnp.asarray(x), jnp.asarray(w), resample_kernel=fir,
                                          **flags))
    got = port_mc.conv2d_layer(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                               resample_kernel=fir, **flags)
    assert_rel(nhwc(got), want, 1e-5)


def test_modulated_conv2d_down_matches_jax(rng):
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    style = rng.randn(2, 16).astype(np.float32)
    w = rng.randn(3, 3, 4, 6).astype(np.float32)
    mw, mb = rng.randn(16, 4).astype(np.float32), rng.randn(4).astype(np.float32)
    want = np.asarray(jax_mc.modulated_conv2d(jnp.asarray(x), jnp.asarray(style), jnp.asarray(w),
                                              jnp.asarray(mw), jnp.asarray(mb), down=True))
    got = port_mc.modulated_conv2d(nchw(x), torch.from_numpy(style),
                                   torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                   torch.from_numpy(mw), torch.from_numpy(mb), down=True)
    assert_rel(nhwc(got), want, 1e-5)
    with pytest.raises(ValueError, match="exclusive"):
        port_mc.modulated_conv2d(nchw(x), torch.from_numpy(style), torch.zeros(6, 4, 3, 3),
                                 torch.from_numpy(mw), torch.from_numpy(mb), up=True, down=True)


@pytest.mark.parametrize("batch,group", [(4, 4), (6, 4), (8, 2)])
def test_minibatch_stddev_matches_jax(rng, batch, group):
    x = rng.randn(batch, 4, 4, 6).astype(np.float32)
    want = np.asarray(jax_g.minibatch_stddev(jnp.asarray(x), group, 2))
    got = port_g.minibatch_stddev(nchw(x), group, 2)
    assert_rel(nhwc(got), want, 1e-5)


def _jax_d(kw, seed=3):
    config = jax_g.GeneratorConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax_g.init_discriminator_params(jax.random.PRNGKey(seed), config))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(  # non-zero biases
        lambda v: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32) if v.ndim == 1 else v, params)
    return config, params


@pytest.mark.parametrize("kw", [TINY_KW, D32_KW], ids=["16px", "32px"])
def test_discriminator_matches_jax(rng, kw):
    config, params = _jax_d(kw)
    images = rng.uniform(-1, 1, (BATCH, kw["resolution"], kw["resolution"], 3)).astype(np.float32)
    want = np.asarray(jax_g.discriminator_apply(params, jnp.asarray(images), config))
    port_params = params_to_device(discriminator_params_from_reference(params), CPU)
    got = port_g.discriminator_apply(port_params, torch.from_numpy(images),
                                     port_g.GeneratorConfig(**kw)).numpy()
    assert got.shape == (BATCH, 1) and got.dtype == np.float32
    assert_rel(got, want, 1e-4)


def test_init_discriminator_params_shapes_match_jax():
    _, jax_params = _jax_d(D32_KW)
    port = port_g.init_discriminator_params(0, port_g.GeneratorConfig(**D32_KW))
    want = discriminator_params_from_reference(jax_params)
    got_leaves = port_training.tree_leaves(port)
    want_leaves = port_training.tree_leaves(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert [v.shape for _, v in got_leaves] == [v.shape for _, v in want_leaves]


def test_discriminator_from_an_nvlabs_pickle(rng, tmp_path):
    """A D in the pickle's layout (HWIO, Dense0 rows NCHW) gives the same
    logits through both packages' loaders."""
    config, jax_params = _jax_d(TINY_KW)
    port_params = discriminator_params_from_reference(jax_params)
    variables = [(path, v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
                 for path, v in port_training.tree_leaves(port_params)]
    state = {"version": 4, "name": "D", "static_kwargs": {}, "components": {},
             "variables": variables}
    port_loader._install_dnnlib_stub_modules()  # pickle as dnnlib.tflib.network.Network
    network_mod = sys.modules["dnnlib.tflib.network"]
    saved = getattr(network_mod, "Network", None)
    network_mod.Network = port_loader._PickleNetwork
    try:
        blob = pickle.dumps((None, port_loader._PickleNetwork(state), None), protocol=2)
    finally:
        if saved is not None:
            network_mod.Network = saved
    path = tmp_path / "gdgs.pkl"
    path.write_bytes(blob)
    images = rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    jax_d = jax_loader.read_network_pickle(path).discriminator
    want = np.asarray(jax_g.discriminator_apply(
        jax_loader.discriminator_params_from_captured(jax_d), jnp.asarray(images), config))
    loaded = port_loader.discriminator_params_from_captured(
        port_loader.read_network_pickle(path).discriminator)
    got = port_g.discriminator_apply(params_to_device(loaded, CPU), torch.from_numpy(images),
                                     port_g.GeneratorConfig(**TINY_KW)).numpy()
    assert_rel(got, want, 1e-4)


# ---------------------------------------------------------------------------
# One train step against JAX
# ---------------------------------------------------------------------------

JAX_TINY = jax_g.GeneratorConfig(**TINY_KW)
PORT_TINY = port_g.GeneratorConfig(**TINY_KW)
JAX_TC = jax_training.TrainingConfig(r1_interval=1, pl_interval=1)
PORT_TC = port_training.TrainingConfig(r1_interval=1, pl_interval=1)


def draws_from_jax_key(key, batch: int) -> port_training.StepDraws:
    """The port's StepDraws for JAX's train_step(state, reals, key), derived
    as gance_tpu/parallel/training.py does: the step's four keys (:297-299),
    `_mixed_dlatents`' masks (:146-151), the noise keys of `generate`
    (:178) and of synthesis (models/stylegan2.py:486, :329), and the PL
    batch's keys (:250-269)."""
    rows, latent, res = JAX_TINY.num_style_rows, JAX_TINY.latent_size, JAX_TINY.resolution

    def normal(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    def mix(rng, n):
        mix_rng, cutoff_rng = jax.random.split(rng)
        do_mix = jax.random.uniform(mix_rng, (n, 1, 1)) < JAX_TC.style_mixing_prob
        cutoff = jax.random.randint(cutoff_rng, (n, 1, 1), 1, rows)
        take = do_mix & (jnp.arange(rows)[None, :, None] >= cutoff)
        return torch.from_numpy(np.array(take)[:, :, 0])

    def noise(rng, n):
        return [normal(jax.random.fold_in(rng, i), (n, s, s, 1)).permute(0, 3, 1, 2).contiguous()
                for i, s in enumerate(port_training.noise_sizes(PORT_TINY))]

    z_rng, mix_rng_d, mix_rng_g, z_rng_g = jax.random.split(key, 4)
    pl_rng = jax.random.fold_in(mix_rng_g, 2)
    pl_batch = batch // JAX_TC.pl_minibatch_shrink
    return port_training.StepDraws(
        z1=normal(z_rng, (batch, latent)),
        z2=normal(jax.random.fold_in(z_rng, 7), (batch, latent)),
        d_mix=mix(mix_rng_d, batch),
        d_noise=noise(jax.random.fold_in(mix_rng_d, 1), batch),
        z1g=normal(z_rng_g, (batch, latent)),
        z2g=normal(jax.random.fold_in(z_rng_g, 7), (batch, latent)),
        g_mix=mix(mix_rng_g, batch),
        g_noise=noise(jax.random.fold_in(mix_rng_g, 1), batch),
        pl_mix=mix(pl_rng, pl_batch),
        pl_noise=noise(jax.random.fold_in(pl_rng, 1), pl_batch),
        pl_probe=normal(jax.random.fold_in(pl_rng, 3), (pl_batch, res, res, 3)) / np.sqrt(res * res),
    )


@pytest.fixture(scope="module")
def jax_step():
    """JAX's state before and after one step, its metrics, and the inputs."""
    state = jax_training.init_training_state(jax.random.PRNGKey(0), JAX_TINY, JAX_TC)
    rng = np.random.RandomState(7)
    # non-zero biases and noise strengths, so their gradients are tested too
    g_params = jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32) if v.ndim <= 1 else v,
        state.g_params)
    g_params = {**g_params, "dlatent_avg": jnp.zeros_like(g_params["dlatent_avg"])}
    state = state._replace(g_params=g_params, ema_params=g_params)
    reals = rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    step = jax.jit(jax_training._make_train_step_core(JAX_TINY, JAX_TC))
    new_state, metrics = step(state, jnp.asarray(reals), key)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return as_np(state), as_np(new_state), as_np(metrics), reals, key


@pytest.fixture(scope="module")
def port_step(jax_step):
    before, _, _, reals, key = jax_step
    state = training_state_from_reference(before, PORT_TC, device="cpu")
    step = port_training.make_train_step(PORT_TINY, PORT_TC)
    state, metrics = step(state, torch.from_numpy(reals), draws_from_jax_key(key, BATCH))
    return state, {k: float(v) for k, v in metrics.items()}


def test_train_step_losses_match_jax(jax_step, port_step):
    _, _, want, _, _ = jax_step
    _, got = port_step
    for name in ("d_loss", "g_loss", "r1", "pl"):
        assert float(want[name]) != 0.0, name
        assert abs(got[name] - float(want[name])) <= 1e-4 * abs(float(want[name])), name


def _leaf_pairs(jax_state, port_state, which):
    convert = discriminator_params_from_reference if which == "d_params" else params_from_reference
    want = dict(port_training.tree_leaves(convert(getattr(jax_state, which))))
    got = port_training.tree_leaves(getattr(port_state, which))
    assert len(got) == len(want)
    return [(path, leaf.detach().numpy(), want[path]) for path, leaf in got]


@pytest.mark.parametrize("net", ["g", "d"])
def test_train_step_gradients_match_jax(jax_step, port_step, net):
    """Adam's first moment after one step is the gradient (b1 = 0)."""
    _, after, _, _, _ = jax_step
    state, _ = port_step
    opt_state = getattr(after, f"{net}_opt_state")[0]
    convert = params_from_reference if net == "g" else discriminator_params_from_reference
    want = dict(port_training.tree_leaves(convert(opt_state.mu)))
    assert int(opt_state.count) == 1
    moments = port_training._adam_to_numpy(getattr(state, f"{net}_opt_state"),
                                           getattr(state, f"{net}_params"))
    assert moments["count"] == 1
    for path, got in port_training.tree_leaves(moments["mu"]):
        scale = float(np.abs(want[path]).max())
        if path.startswith("synthesis/noise") or path == "dlatent_avg":
            assert scale == 0.0 and float(np.abs(got).max()) == 0.0, path
            continue
        assert scale > 0.0, path
        np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-4 * scale, err_msg=path)


@pytest.mark.parametrize("which", ["g_params", "d_params", "ema_params"])
def test_train_step_params_match_jax(jax_step, port_step, which):
    """Within 1e-5 plus 2 fp32 ulps of the value (PARAM_RTOL): the mapping
    weights are about 100 in size, where one ulp is 7.6e-6, and XLA may fuse
    the EMA's multiply-add where PyTorch rounds twice."""
    before, after, _, _, _ = jax_step
    state, _ = port_step
    lr = PORT_TC.learning_rate
    if which == "ema_params":
        # EMA moves by (1 - beta) of G's update: within 1e-5 everywhere,
        # the elements of the Adam caveat included (0.001 * 2 lr)
        for path, got, want in _leaf_pairs(after, state, which):
            assert bool(np.all(np.abs(got - want) <= PARAM_ATOL + PARAM_RTOL * np.abs(want))), path
        return
    old = dict((p, w) for p, _, w in _leaf_pairs(before, state, which))
    for path, got, want in _leaf_pairs(after, state, which):
        moved = np.abs(want - old[path])
        near_zero_grad = (moved < 0.99 * lr) & (moved > 0) & (path != "dlatent_avg")
        assert float(np.mean(near_zero_grad)) < 0.01, path
        diff = np.abs(got - want)
        if path != "dlatent_avg":
            assert float(diff.max()) <= 2.0 * lr + 1e-6, path
        limit = PARAM_ATOL + PARAM_RTOL * np.abs(want)
        assert bool(np.all((diff <= limit) | near_zero_grad)), path


def test_train_step_pl_mean_and_step_match_jax(jax_step, port_step):
    _, after, _, _, _ = jax_step
    state, _ = port_step
    assert state.step == int(after.step) == 1
    assert float(after.pl_mean) > 0.0
    assert abs(float(state.pl_mean) - float(after.pl_mean)) <= 1e-5


# ---------------------------------------------------------------------------
# The port on its own: bf16, resume, draws, refusals
# ---------------------------------------------------------------------------


def _reals(seed=0):
    return torch.from_numpy(np.random.RandomState(seed).uniform(-1, 1, (BATCH, 16, 16, 3))
                            .astype(np.float32))


def _run_steps(state, steps, train_config=PORT_TC, seed=5):
    step_fn = port_training.make_train_step(PORT_TINY, train_config)
    metrics = None
    for _ in range(steps):
        draws = port_training.draw_step(seed, state.step, BATCH, PORT_TINY, train_config, CPU)
        state, metrics = step_fn(state, _reals(state.step), draws)
    return state, metrics


def test_bf16_step_is_finite_and_close_to_fp32():
    """bf16 rounds activations to 8 bits of mantissa: losses within 5e-2."""
    bf16 = port_training.TrainingConfig(r1_interval=1, pl_interval=1, compute_dtype="bfloat16")
    _, m32 = _run_steps(port_training.init_training_state(1, PORT_TINY, PORT_TC, CPU), 1)
    state, m16 = _run_steps(port_training.init_training_state(1, PORT_TINY, bf16, CPU), 1, bf16)
    for name in ("d_loss", "g_loss", "r1", "pl"):
        assert bool(torch.isfinite(m16[name])), name
        assert abs(float(m16[name]) - float(m32[name])) <= 5e-2 * abs(float(m32[name])), name
    for _, leaf in port_training.tree_leaves(state.g_params):
        assert leaf.dtype == torch.float32 and bool(torch.isfinite(leaf).all())


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """2 steps, save, load, 2 more steps == 4 unbroken steps, bit for bit."""
    tc = port_training.TrainingConfig(r1_interval=2, pl_interval=2)
    unbroken, m_unbroken = _run_steps(port_training.init_training_state(3, PORT_TINY, tc, CPU), 4, tc)
    half, _ = _run_steps(port_training.init_training_state(3, PORT_TINY, tc, CPU), 2, tc)
    path = tmp_path / "ckpt.pkl"
    port_training.save_checkpoint(path, half)
    assert not (tmp_path / "ckpt.pkl.tmp").exists()
    resumed = port_training.load_checkpoint(path, tc, CPU)
    assert resumed.step == 2
    resumed, m_resumed = _run_steps(resumed, 2, tc)
    assert resumed.step == unbroken.step == 4
    for name in m_unbroken:
        assert float(m_resumed[name]) == float(m_unbroken[name]), name
    assert float(resumed.pl_mean) == float(unbroken.pl_mean)
    for which in ("g_params", "d_params", "ema_params"):
        for (p, a), (_, b) in zip(port_training.tree_leaves(getattr(resumed, which)),
                                  port_training.tree_leaves(getattr(unbroken, which))):
            assert torch.equal(a, b), (which, p)
    for net in ("g", "d"):
        a = port_training._adam_to_numpy(getattr(resumed, f"{net}_opt_state"),
                                         getattr(resumed, f"{net}_params"))
        b = port_training._adam_to_numpy(getattr(unbroken, f"{net}_opt_state"),
                                         getattr(unbroken, f"{net}_params"))
        assert a["count"] == b["count"] == 4
        for (_, x), (_, y) in zip(port_training.tree_leaves(a["nu"]),
                                  port_training.tree_leaves(b["nu"])):
            assert np.array_equal(x, y)


GOLDEN_KW = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32, dlatent_size=32,
                 mapping_layers=2, mapping_fmaps=32)  # tests/test_golden_image.py's config


def test_phase_path_train_step_matches_standard_path(monkeypatch):
    """One train step with R1 and path length, GANCE_TPU_PHASE1024=on against
    off, with the same state and draws, at the 32px golden config (a 32-channel
    top block, so the phase path applies): the phase path runs kernel E's
    Function in the three syntheses (fakes for D, fakes for G, PL's batch)
    and PL differentiates through E twice. Losses within 1e-4 relative; the
    G step's gradients within 1e-3 of each leaf's norm (the same operator,
    reassociated)."""
    config = port_g.GeneratorConfig(**GOLDEN_KW)
    assert port_g.resolve_phase_top_block(config, True)
    reals = torch.from_numpy(np.random.RandomState(8).uniform(-1, 1, (BATCH, 32, 32, 3))
                             .astype(np.float32))
    draws = port_training.draw_step(6, 0, BATCH, config, PORT_TC, CPU)
    from gance_tpu_torch.ops.cuda import fused_ops as K

    runs = []
    real_run = K._phase_conv1_torgb_run

    def counted(*args):
        runs.append(args[0].shape)
        return real_run(*args)

    monkeypatch.setattr(K, "_phase_conv1_torgb_run", counted)
    results = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("GANCE_TPU_PHASE1024", mode)
        runs.clear()
        state = port_training.init_training_state(2, config, PORT_TC, CPU)
        grads, _ = port_training.g_step_gradients(state.g_params, state.d_params, draws,
                                                  state.pl_mean, True, config, PORT_TC)
        _, metrics = port_training.make_train_step(config, PORT_TC)(state, reals, draws)
        results[mode] = grads, {k: float(v) for k, v in metrics.items()}
        # g_step_gradients: G's fakes and PL's batch; the step: D's fakes too
        assert [r[0] for r in runs] == ([BATCH, BATCH // 2, BATCH, BATCH, BATCH // 2]
                                        if mode == "on" else [])
    (g_off, m_off), (g_on, m_on) = results["off"], results["on"]
    for name in ("d_loss", "g_loss", "r1", "pl", "pl_length"):
        assert m_off[name] != 0.0, name
        assert abs(m_on[name] - m_off[name]) <= 1e-4 * abs(m_off[name]), name
    leaves = port_training.tree_leaves(port_training.init_training_state(
        2, config, PORT_TC, CPU).g_params)
    for (path, _), a, b in zip(leaves, g_on, g_off):
        norm = float(b.norm())
        if norm == 0.0:
            assert float(a.abs().max()) == 0.0, path
            continue
        assert float((a - b).norm()) <= 1e-3 * norm, path


def test_draw_step_is_a_function_of_seed_and_step():
    a = port_training.draw_step(1, 3, BATCH, PORT_TINY, PORT_TC, CPU)
    b = port_training.draw_step(1, 3, BATCH, PORT_TINY, PORT_TC, CPU)
    c = port_training.draw_step(1, 4, BATCH, PORT_TINY, PORT_TC, CPU)
    assert torch.equal(a.z1, b.z1) and torch.equal(a.pl_probe, b.pl_probe)
    assert not torch.equal(a.z1, c.z1)
    assert a.d_mix.shape == (BATCH, PORT_TINY.num_style_rows) and a.d_mix.dtype == torch.bool
    assert [tuple(n.shape) for n in a.g_noise] == [
        (BATCH, 1, s, s) for s in (4, 8, 8, 16, 16)]
    assert a.pl_probe.shape == (BATCH // 2, 16, 16, 3) and len(a.pl_noise[0]) == BATCH // 2


def test_not_ported_options_raise(monkeypatch):
    """A tensor-parallel 'model' axis of 2, which raised before it was
    ported, trains: one step with R1 and PL over a model-2 mesh (the large
    weights, their Adam moments and the EMA split over the slots) gives the
    single-device step's losses within 1e-4 relative and its leaves within
    1e-4 of their size; the replicated leaves are one tensor on the lead."""
    from gance_tpu_torch.parallel import mesh as port_mesh
    from gance_tpu_torch.parallel.tensor_parallel import GroupParams

    monkeypatch.setattr(port_mesh, "_MIN_SHARDED_PARAM", 1024)
    mesh = port_mesh.Mesh(port_mesh._object_grid([port_mesh.MeshDevice(0, CPU)] * 2, (1, 2)),
                          ("data", "model"))
    tc = port_training.TrainingConfig(r1_interval=1, pl_interval=1)
    reals = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (BATCH, 16, 16, 3)).astype(np.float32))
    draws = port_training.draw_step(3, 0, BATCH, PORT_TINY, tc, CPU)
    results = []
    for step_mesh in (None, mesh):
        state = port_training.init_training_state(4, PORT_TINY, tc, CPU)
        if step_mesh is not None:
            state = port_training.shard_training_state(step_mesh, state, tc)
            assert isinstance(state.g_params, GroupParams)
            assert state.g_params.slots[0]["dlatent_avg"] is state.g_params.slots[1]["dlatent_avg"]
        state, metrics = port_training.make_train_step(PORT_TINY, tc, mesh=step_mesh)(
            state, reals, draws)
        results.append(({k: float(v) for k, v in metrics.items()},
                        port_training.tree_to_numpy(state.g_params)))
    (m_one, g_one), (m_tp, g_tp) = results
    for name in ("d_loss", "g_loss", "r1", "pl"):
        assert abs(m_tp[name] - m_one[name]) <= 1e-4 * abs(m_one[name]), name
    for path, want in port_training.tree_leaves(g_one):
        got = dict(port_training.tree_leaves(g_tp))[path]
        assert float(np.abs(got - want).max()) <= 1e-4 * max(float(np.abs(want).max()), 1.0), path


def test_training_config_defaults_match_jax():
    jax_fields = {k: v for k, v in vars(jax_training.TrainingConfig()).items()}
    port_fields = {k: v for k, v in vars(port_training.TrainingConfig()).items()}
    assert port_fields == jax_fields


# ---------------------------------------------------------------------------
# Dataset and CLI
# ---------------------------------------------------------------------------


def _image_dir(tmp_path, count=6, side=16):
    from gance_tpu.media.images import write_image

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(count):
        write_image((rng.rand(side, side, 3) * 255).astype(np.uint8), data / f"{i}.png")
    return data


def test_streaming_dataset_matches_jax(tmp_path):
    from gance_tpu.parallel.data import StreamingImageDataset as JaxDataset
    from gance_tpu_torch.parallel.data import StreamingImageDataset

    data = _image_dir(tmp_path, side=20)
    ours, theirs = StreamingImageDataset(data, 16, seed=3), JaxDataset(data, 16, seed=3)
    got = list(ours.batches(2, 5, 3))
    want = list(theirs.batches(2, 5, 3))
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 3, 4]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_train_cli_resume_and_export(tmp_path):
    from click.testing import CliRunner

    from gance_tpu_torch.cli.train import cli

    data = _image_dir(tmp_path)
    ckpt, out_net = tmp_path / "ckpt.pkl", tmp_path / "trained.pkl"
    args = [
        "--dataset-directory", str(data), "--resolution", "16", "--batch-size", "4",
        "--fmap-base", "256", "--fmap-max", "32", "--latent-size", "16",
        "--checkpoint-path", str(ckpt), "--checkpoint-every", "2",
        "--output-network", str(out_net), "--device", "cpu",
    ]
    result = CliRunner().invoke(cli, args + ["--total-steps", "2"], catch_exceptions=False)
    assert result.exit_code == 0 and ckpt.exists() and out_net.exists()
    assert port_training.load_checkpoint(ckpt, device="cpu").step == 2
    result = CliRunner().invoke(cli, args + ["--total-steps", "3"], catch_exceptions=False)
    assert result.exit_code == 0
    state = port_training.load_checkpoint(ckpt, device="cpu")
    assert state.step == 3
    port_params, port_config = port_loader.load_generator(out_net)
    jax_params, jax_config = jax_loader.load_generator(out_net)
    assert port_config.resolution == jax_config.resolution == 16
    ema = port_training.tree_to_numpy(state.ema_params)
    np.testing.assert_array_equal(port_params["dlatent_avg"], ema["dlatent_avg"])
    z = np.random.RandomState(0).randn(2, 16).astype(np.float32)
    with torch.inference_mode():
        got = port_g.generator_apply(params_to_device(port_params, CPU), torch.from_numpy(z),
                                     port_config).numpy()
    want = np.asarray(jax_g.generator_apply(jax_params, jnp.asarray(z), jax_config))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
