"""
The port's remat (a non-reentrant torch.utils.checkpoint per synthesis block,
phase top block and resnet block of D) and scanned step segments, on the CPU:

  * a remat train step with R1 and path length equals the plain step bit for
    bit (JAX's tests/test_parallel.py::test_train_step_remat_is_numerically_identical
    holds rtol 1e-6), on the standard path and on the phase path, where path
    length differentiates kernel E's Function twice inside a checkpoint;
  * remat with noise_mode="random" and a generator: the noise is drawn before
    each checkpoint, so the recompute sees the same planes and the gradients
    equal the plain ones;
  * `Projector(remat=True)` trajectories equal the plain ones (JAX's
    tests/test_projection.py::test_remat_matches_non_remat_trajectory);
  * `make_train_scan` over S steps equals S single steps (JAX's
    tests/test_parallel.py::test_train_scan_matches_per_step), bit for bit;
  * `run_training(scan_segment=3)` over 7 steps with a checkpoint every 4
    equals the per-step run and resumes from its checkpoint.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.ops.cuda import fused_ops as K  # noqa: E402
from gance_tpu_torch.parallel import training as T  # noqa: E402
from gance_tpu_torch.projection import projector as port_proj  # noqa: E402
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

TINY_KW = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
               mapping_layers=2, mapping_fmaps=16)
GOLDEN_KW = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32, dlatent_size=32,
                 mapping_layers=2, mapping_fmaps=32)  # a 32-channel top block: the phase path
BATCH = 4
CPU = torch.device("cpu")
PHASE_ENV = "GANCE_TPU_PHASE1024"


def _reals(config, seed=0, batch=BATCH):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        -1, 1, (batch, config.resolution, config.resolution, 3)).astype(np.float32))


def _all_leaves(state):
    return [(f"{which}/{p}", v) for which in ("g_params", "d_params", "ema_params")
            for p, v in T.tree_leaves(getattr(state, which))]


def _count_runs(monkeypatch):
    """Each kernel's forward runs; C's phase-plane form counts as C's."""
    counts = {}
    for name in ("_fused_bias_noise_lrelu_run", "_upsample2x_blur_run",
                 "_blur4_separable_pad11_run", "_blur4_separable_pad11_phases_run",
                 "_stencil_blur4_valid_run", "_phase_conv1_torgb_run"):
        real = getattr(K, name)
        key = name.replace("_phases", "")

        def counted(*args, _real=real, _name=key):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*args)

        monkeypatch.setattr(K, name, counted)
    return counts


@pytest.mark.parametrize("path", ["standard", "phase"])
def test_remat_train_step_equals_plain_step(monkeypatch, path):
    """One step with R1 and PL: losses, every G, D and EMA leaf and pl_mean
    equal (rtol 1e-6 at most; the CPU gives equality). Recompute runs the
    kernels again: the synthesis blocks 3 more times in the G step (PL's
    input gradient, then G's fakes and PL's batch in the parameter gradient),
    the resnet blocks of D 3 more times in the D step (R1's input gradient,
    then fakes and reals) and once more in the G step."""
    kw = TINY_KW if path == "standard" else GOLDEN_KW
    config = port_g.GeneratorConfig(**kw)
    monkeypatch.setenv(PHASE_ENV, "on" if path == "phase" else "off")
    phase = port_g.resolve_phase_top_block(config)
    assert phase == (path == "phase")
    counts = _count_runs(monkeypatch)
    results = {}
    for remat in (False, True):
        tc = T.TrainingConfig(r1_interval=1, pl_interval=1, remat=remat)
        state = T.init_training_state(2, config, tc, CPU)
        draws = T.draw_step(6, 0, BATCH, config, tc, CPU)
        counts.clear()
        state, metrics = T.make_train_step(config, tc)(state, _reals(config, 8), draws)
        results[remat] = state, {k: float(v) for k, v in metrics.items()}, dict(counts)
    (plain, m_plain, c_plain), (remat, m_remat, c_remat) = results[False], results[True]
    for name, value in m_plain.items():
        assert value != 0.0 and abs(m_remat[name] - value) <= 1e-6 * abs(value), name
    assert float(remat.pl_mean) == pytest.approx(float(plain.pl_mean), rel=1e-6)
    for (p, a), (_, b) in zip(_all_leaves(remat), _all_leaves(plain)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=p)
    blocks = config.resolution_log2 - 2
    d_forward = 2 * blocks  # kernel D per discriminator forward
    extra = {"_fused_bias_noise_lrelu_run": 3 * 2 * (blocks - phase),
             "_upsample2x_blur_run": 3 * (blocks - phase),
             "_blur4_separable_pad11_run": 3 * (blocks - phase),
             "_stencil_blur4_valid_run": 3 * d_forward + d_forward,
             "_phase_conv1_torgb_run": 3 * phase}
    assert {k: c_remat.get(k, 0) - c_plain.get(k, 0) for k in extra} == extra


def test_remat_with_random_noise_from_a_generator():
    """noise_mode="random" from a torch.Generator under remat: the forward and
    the gradients w.r.t. w+ and every param equal the plain ones."""
    config = port_g.GeneratorConfig(**TINY_KW)
    params = port_g.init_generator_params(3, config)
    for layer in ("Conv0_up", "Conv1"):
        params["synthesis"]["16x16"][layer]["noise_strength"] = np.float32(0.5)
    dl = torch.from_numpy(np.random.RandomState(4).randn(2, config.num_style_rows,
                                                         config.dlatent_size).astype(np.float32))
    probe = torch.from_numpy(np.random.RandomState(5).randn(2, 16, 16, 3).astype(np.float32))
    out = {}
    for remat in (False, True):
        p = params_to_device(params, CPU)
        leaves = [v.requires_grad_(True) for _, v in T.tree_leaves(p)]
        w = dl.clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(11)
        images = port_g.synthesis_apply(p, w, config, noise_mode="random", generator=gen,
                                        remat=remat)
        grads = torch.autograd.grad((images * probe).sum(), [w] + leaves, allow_unused=True)
        out[remat] = images.detach(), [g for g in grads if g is not None]
    (img_a, g_a), (img_b, g_b) = out[False], out[True]
    assert torch.equal(img_a, img_b)
    assert len(g_a) == len(g_b) > 1
    for a, b in zip(g_a, g_b):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)


def test_remat_uint8_output_keeps_the_float_path(monkeypatch):
    """With remat the phase path's uint8 output is images_to_uint8 of the float
    render (JAX: `uint8_output and not remat` takes the fused epilogue)."""
    monkeypatch.setenv(PHASE_ENV, "on")
    config = port_g.GeneratorConfig(**GOLDEN_KW)
    params = params_to_device(port_g.init_generator_params(5, config), CPU)
    dl = torch.from_numpy(np.random.RandomState(6).randn(2, config.num_style_rows,
                                                         config.dlatent_size).astype(np.float32))
    counts = _count_runs(monkeypatch)
    with torch.no_grad():
        got = port_g.synthesis_apply(params, dl, config, uint8_output=True, remat=True)
        want = port_g.images_to_uint8(port_g.synthesis_apply(params, dl, config))
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    # the float path interleaves the last skip upsample with B both times
    assert counts["_upsample2x_blur_run"] == 2 * (config.resolution_log2 - 2)


def test_projector_remat_trajectories_equal_plain():
    config = port_g.GeneratorConfig(**TINY_KW)
    params = port_g.init_generator_params(21, config)
    targets = (np.random.RandomState(9).rand(2, 16, 16, 3) * 255).astype(np.uint8)
    runs = []
    for remat in (False, True):
        settings = port_proj.ProjectorSettings(num_steps=4, dlatent_avg_samples=64,
                                               perceptual_size=16, remat=remat)
        projector = port_proj.Projector(params, config, settings=settings, device="cpu")
        runs.append(projector.project_batch(targets, want_step_images=False,
                                            per_step_noises=False))
    for a, b in zip(*runs):
        np.testing.assert_allclose(b.final_latents, a.final_latents, rtol=1e-6, atol=1e-7)
        assert b.final_distance == pytest.approx(a.final_distance, rel=1e-6)
        for na, nb in zip(a.noises, b.noises):
            np.testing.assert_allclose(nb, na, rtol=1e-6, atol=1e-7)


def _states_equal(a, b):
    assert a.step == b.step
    assert torch.equal(a.pl_mean, b.pl_mean)
    for (p, x), (_, y) in zip(_all_leaves(a), _all_leaves(b)):
        assert torch.equal(x, y), p


def test_train_scan_equals_single_steps():
    """4 scanned steps (R1 every 2, PL every 2) equal 4 single steps bit for
    bit; the scan's metrics are stacked (4,) tensors."""
    config = port_g.GeneratorConfig(**TINY_KW)
    tc = T.TrainingConfig(r1_interval=2, pl_interval=2)
    steps = 4
    reals = np.stack([_reals(config, s).numpy() for s in range(steps)])
    draws = [T.draw_step(5, s, BATCH, config, tc, CPU) for s in range(steps)]
    single = T.init_training_state(0, config, tc, CPU)
    step_fn = T.make_train_step(config, tc)
    per_step = []
    for s in range(steps):
        single, metrics = step_fn(single, torch.from_numpy(reals[s]), draws[s])
        per_step.append(metrics)
    scanned, stacked = T.make_train_scan(config, tc)(T.init_training_state(0, config, tc, CPU),
                                                     reals, draws)
    _states_equal(scanned, single)
    for name in per_step[0]:
        assert stacked[name].shape == (steps,)
        assert torch.equal(stacked[name], torch.stack([m[name] for m in per_step])), name
    assert float(stacked["r1"][1]) == 0.0 and float(stacked["r1"][2]) != 0.0
    with pytest.raises(ValueError, match="draws"):
        T.make_train_scan(config, tc)(single, reals, draws[:2])


class _Images:
    """The dataset interface of `run_training`: step s's batch from (seed, s)."""

    def __init__(self, resolution):
        self.images = np.random.RandomState(1).uniform(
            -1, 1, (6, resolution, resolution, 3)).astype(np.float32)

    def batches(self, start, total, batch):
        for step in range(start, total):
            yield step, self.images[np.random.RandomState(step).randint(0, 6, batch)]


def test_run_training_scan_segment_equals_per_step_and_resumes(tmp_path):
    """7 steps with a checkpoint every 4: segments of 3 run [0-2], [3] (cut at
    the checkpoint), [4-6]; the state equals the per-step run's bit for bit,
    the hooks run per segment, and a resume from the step-4 checkpoint ends
    at the same state."""
    config = port_g.GeneratorConfig(**TINY_KW)
    tc = T.TrainingConfig(r1_interval=2, pl_interval=2)
    data = _Images(config.resolution)
    per_step = T.run_training(data, config, tc, tmp_path / "a.ckpt", 7, BATCH,
                              checkpoint_every=4, seed=3, device="cpu")
    seen, evals = [], []
    kwargs = dict(checkpoint_every=4, seed=3, device="cpu", scan_segment=3,
                  before_step=lambda s: seen.append(("before", s)),
                  after_step=lambda s, state, m: seen.append(("after", s, state.step,
                                                              tuple(m["d_loss"].shape))),
                  metrics_hook=lambda s, state: evals.append((s, state.step)))
    scanned = T.run_training(data, config, tc, tmp_path / "b.ckpt", 7, BATCH, **kwargs)
    _states_equal(scanned, per_step)
    assert seen == [("before", 0), ("after", 2, 3, ()), ("before", 3), ("after", 3, 4, ()),
                    ("before", 4), ("after", 6, 7, ())]
    assert evals == [(4, 4), (7, 7)]
    # resume: the step-4 checkpoint, then 3 more steps in one segment
    four = T.run_training(data, config, tc, tmp_path / "c.ckpt", 4, BATCH, checkpoint_every=4,
                          seed=3, device="cpu", scan_segment=3)
    assert four.step == 4
    seen.clear()
    resumed = T.run_training(data, config, tc, tmp_path / "c.ckpt", 7, BATCH, **kwargs)
    _states_equal(resumed, per_step)
    assert seen[0] == ("before", 4) and len(seen) == 2
    with pytest.raises(ValueError, match="scan_segment"):
        T.run_training(data, config, tc, tmp_path / "d.ckpt", 1, BATCH, device="cpu",
                       scan_segment=0)
