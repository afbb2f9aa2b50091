"""
The port's projector (gance_tpu_torch/projection/projector.py), its writer
loop (file_writer.py::project_video_to_file) and its CLI against gance_tpu's,
on the CPU, with the same numpy inputs handed to both.

The networks have non-zero noise strengths and biases: with
init_generator_params' zero strengths the noise planes would get their
gradient from the regulariser alone, and a dropped noise gradient would pass.
The port's draws (dlatent average, initial planes, jitter) do not equal JAX's,
so parity is held where JAX's projector is deterministic: the same z into
both mappings, one step with the jitter given, and whole runs with pinned
starts (initial_latents, initial_noises) and noise_factor 0.

Tolerances, each with its reason:
  * schedule, regulariser, normalisation, dlatent statistics: 1e-6 relative
    (the same fp32 arithmetic, reduced in another order);
  * one step's loss and its w and noise gradients against jax.value_and_grad
    of the same composition: 1e-4 of each value's scale (synthesis, VGG16 and
    their backward passes in fp32, reassociated);
  * Adam and the noise normalisation over 5 scheduled steps against optax:
    1e-6 of the parameters' scale;
  * pinned-start trajectories against TPUProjector.project_batch: per-step
    distances within 1e-4 relative, latents and noises within 1e-3 of their
    norm, per-step images within 1 uint8 step (the one-step bound carried
    through 5 steps of Adam);
  * the segmented loop against the per-step loop: bit for bit (the same
    operations in the same order);
  * one frame in a batch against the same frame alone: 1e-4 (the convolutions
    sum a batch in another blocking).
"""

import os
from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from gance_tpu.media.video import write_source_to_disk_consume  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.models.pickle_loader import save_generator_pickle  # noqa: E402
from gance_tpu.projection import file_reader as jax_reader  # noqa: E402
from gance_tpu.projection import file_writer as jax_writer  # noqa: E402
from gance_tpu.projection import lpips as jax_lpips  # noqa: E402
from gance_tpu.projection import projector as jax_proj  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.ops import upfirdn2d as port_up  # noqa: E402
from gance_tpu_torch.projection import file_reader as port_reader  # noqa: E402
from gance_tpu_torch.projection import file_writer as port_writer  # noqa: E402
from gance_tpu_torch.projection import lpips as port_lpips  # noqa: E402
from gance_tpu_torch.projection import projector as port_proj  # noqa: E402
from tests.test_vgg_import import _write_nvlabs_lpips_pickle  # noqa: E402
from tests.torch_parallel_worker import cpu_slots  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(resolution=16, fmap_base=256, fmap_max=32, latent_size=16, dlatent_size=16,
            mapping_layers=2, mapping_fmaps=16)
SMALL = dict(resolution=32, fmap_base=512, fmap_max=64, latent_size=32, dlatent_size=32,
             mapping_layers=2, mapping_fmaps=32)
STEPS = 5
BATCH = 3
PHASE_ENV = "GANCE_TPU_PHASE1024"


def jax_params(seed: int, config: dict) -> dict:
    """JAX generator params as numpy, with non-zero noise strengths, biases and
    dlatent_avg."""
    params = jax.tree_util.tree_map(
        np.array, jax_g.init_generator_params(jax.random.PRNGKey(seed), jax_g.GeneratorConfig(**config)))
    rng = np.random.RandomState(seed)
    for name, block in params["synthesis"].items():
        for layer in block.values() if name != "noise" else ():
            if "bias" in layer:
                layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(rng.uniform(0.1, 0.3))
    params["dlatent_avg"] = (0.3 * rng.randn(config["dlatent_size"])).astype(np.float32)
    return params


def noise_names(params: dict) -> list:
    return sorted(params["synthesis"]["noise"], key=lambda n: int(n[5:]))


def pinned_inputs(params: dict, config: dict, batch: int, seed: int):
    """Targets (uint8), w starts and initial noises in JAX's layout."""
    rng = np.random.RandomState(seed)
    res = config["resolution"]
    targets = (rng.rand(batch, res, res, 3) * 255).astype(np.uint8)
    w0 = rng.randn(batch, config["dlatent_size"]).astype(np.float32)
    noises = [rng.randn(batch, *params["synthesis"]["noise"][n].shape[1:]).astype(np.float32)
              for n in noise_names(params)]
    return targets, w0, noises


def port_projector(params: dict, config: dict, **settings) -> port_proj.Projector:
    return port_proj.Projector(params_from_reference(params), port_g.GeneratorConfig(**config),
                               settings=port_proj.ProjectorSettings(**settings), device="cpu")


def nchw(buffers) -> list:
    return [torch.from_numpy(np.ascontiguousarray(b.transpose(0, 3, 1, 2))) for b in buffers]


def norm_close(got: np.ndarray, want: np.ndarray, rel: float) -> float:
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))
    assert err <= rel, err
    return err


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def test_settings_and_result_match_jax():
    assert asdict(port_proj.ProjectorSettings()) == asdict(jax_proj.ProjectorSettings())
    assert port_proj.ProjectionResult._fields == jax_proj.ProjectionResult._fields
    assert port_writer.DEFAULT_EXPECTED_TIME_PER_STEP == jax_writer.DEFAULT_EXPECTED_TIME_PER_STEP
    assert port_writer.DEFAULT_STEPS_PER_PROJECTION == jax_writer.DEFAULT_STEPS_PER_PROJECTION
    settings = port_proj.ProjectorSettings(num_steps=40, convergence_window=30)
    assert settings.resolved_convergence_min_steps() == jax_proj.ProjectorSettings(
        num_steps=40, convergence_window=30).resolved_convergence_min_steps()


@pytest.mark.parametrize("t", [0.0, 0.01, 0.03, 0.05, 0.2, 0.5, 0.75, 0.8, 0.99, 0.999])
def test_lr_schedule_matches_jax(t):
    settings = port_proj.ProjectorSettings()
    want = float(jax_proj._lr_schedule(jnp.float32(t), jax_proj.ProjectorSettings()))
    got = float(port_proj._lr_schedule(t, settings))
    assert abs(got - want) <= 1e-6 * settings.initial_learning_rate


def test_noise_regularization_and_normalization_match_jax():
    rng = np.random.RandomState(2)
    buffers = [rng.randn(3, s, s, 1).astype(np.float32) * (1 + 0.3 * rng.randn(3, 1, 1, 1))
               .astype(np.float32) + 0.2 for s in (4, 8, 8, 16, 16, 32, 32)]
    want = np.asarray(jax_proj._noise_regularization([jnp.asarray(b) for b in buffers]))
    got = port_proj._noise_regularization(nchw(buffers)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    want_n = jax_proj._normalize_noises([jnp.asarray(b) for b in buffers])
    got_n = port_proj._normalize_noises(nchw(buffers))
    for g, w in zip(got_n, want_n):
        w = np.asarray(w)
        np.testing.assert_allclose(port_proj.to_jax_layout(g), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("trace_seed,epsilon,window,min_steps", [
    (0, 0.01, 5, 0), (1, 0.5, 5, 0), (2, 0.01, 10, 100), (3, 1e-4, 3, 6), (4, 0.2, 8, 0)])
def test_convergence_should_stop_matches_jax(trace_seed, epsilon, window, min_steps):
    rng = np.random.RandomState(trace_seed)
    length = 40
    decay = np.exp(-np.arange(length) / rng.uniform(3, 30))[:, None]
    trace = decay * rng.uniform(0.5, 2, (1, 3)) + 0.01 * rng.rand(length, 3)
    for t in (trace, trace[:, 0], trace[: 2 * window - 1]):
        assert port_proj.convergence_should_stop(t, window, epsilon, min_steps) == \
            jax_proj.convergence_should_stop(t, window, epsilon, min_steps)


def test_dlatent_statistics_match_jax():
    params = jax_params(3, TINY)
    z = np.random.RandomState(3).randn(2000, TINY["latent_size"]).astype(np.float32)
    w = jax_g.mapping_apply(params, jnp.asarray(z), jax_g.GeneratorConfig(**TINY))
    want_avg = np.asarray(jnp.mean(w, axis=0, keepdims=True))
    want_std = float(jnp.sqrt(jnp.mean(jnp.sum(jnp.square(w - want_avg), axis=1))))
    avg, std = port_proj.dlatent_statistics(
        port_proj.params_to_device(params_from_reference(params), CPU), torch.from_numpy(z),
        port_g.GeneratorConfig(**TINY))
    assert tuple(avg.shape) == (1, TINY["dlatent_size"])
    np.testing.assert_allclose(avg.numpy(), want_avg, rtol=0,
                               atol=1e-6 * float(np.abs(want_avg).max()))
    assert abs(std - want_std) <= 1e-6 * want_std


def test_target_resize_and_downsample_match_jax():
    """A target whose side differs from the network's: jax.image.resize
    "linear" (antialiased) to the network's side, then average-pooled to the
    perceptual size, as TPUProjector.project_batch prepares it."""
    targets = (np.random.RandomState(4).rand(2, 40, 40, 3) * 255).astype(np.uint8)
    want = jax.image.resize(jnp.asarray(targets, jnp.float32) / 127.5 - 1.0, (2, 32, 32, 3),
                            method="linear")
    want = np.asarray(jax_lpips.downsample_to(want, 16)).transpose(0, 3, 1, 2)
    projector = port_projector(jax_params(4, SMALL), SMALL, dlatent_avg_samples=16,
                               perceptual_size=16)
    got = projector._target_proc(targets).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one step against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", [False, True])
def test_one_step_loss_and_gradients_match_jax(monkeypatch, phase):
    """The loss (distance summed over frames + weight * the noise regulariser)
    and its gradient with respect to w and every noise plane, at 32px (the top
    block runs on the phase path when `phase`), perceptual size 16 (so the
    images are average-pooled), against jax.value_and_grad of the same
    composition built from JAX's functions. With the projector's weight of
    1e5 the regulariser's gradient outweighs the synthesis term in the noise
    gradient by about 1e5, so the case of weight 0 holds the synthesis term
    alone: a dropped noise gradient gives zeros there."""
    monkeypatch.setenv(PHASE_ENV, "on" if phase else "off")
    params = jax_params(5, SMALL)
    config = jax_g.GeneratorConfig(**SMALL)
    targets, w0, noises = pinned_inputs(params, SMALL, 2, seed=5)
    jitter = (0.1 * np.random.RandomState(6).randn(*w0.shape)).astype(np.float32)
    perceptual = jax_lpips.random_vgg_params(0)
    names = noise_names(params)
    target_proc = jax_lpips.downsample_to(jnp.asarray(targets, jnp.float32) / 127.5 - 1.0, 16)

    def loss_fn(w, planes, weight):
        dlatents = jnp.tile((w + jitter)[:, None, :], (1, config.num_style_rows, 1))
        tree = dict(params, synthesis=dict(params["synthesis"],
                                           noise={n: p for n, p in zip(names, planes)}))
        images = jax_g.synthesis_apply(tree, dlatents, config, noise_mode="const",
                                       phase_top_block_mode=phase)
        dist = jax_lpips.lpips_distance(perceptual, jax_lpips.downsample_to(images, 16),
                                        target_proc)
        reg = jax_proj._noise_regularization(planes) * weight
        return jnp.sum(dist + reg), dist

    jax_step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    projector = port_projector(params, SMALL, dlatent_avg_samples=16, perceptual_size=16)
    assert port_g.resolve_phase_top_block(projector.config) == phase
    for weight in (1e5, 0.0):
        (want_loss, want_dist), (want_gw, want_gn) = jax_step(
            jnp.asarray(w0), [jnp.asarray(n) for n in noises], jnp.float32(weight))
        projector.settings.regularize_noise_weight = weight
        loss, dist, images, grads = projector._loss_and_gradients(
            torch.from_numpy(w0), nchw(noises), projector._target_proc(targets),
            torch.from_numpy(jitter))
        assert tuple(images.shape) == (2, 32, 32, 3) and images.dtype == torch.float32
        assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
        np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist), rtol=1e-4)
        want_gw = np.asarray(want_gw)
        np.testing.assert_allclose(grads[0].numpy(), want_gw, rtol=0,
                                   atol=1e-4 * float(np.abs(want_gw).max()))
        assert len(grads) == 1 + len(names)
        for i, (g, w) in enumerate(zip(grads[1:], want_gn)):
            w = np.asarray(w)
            assert float(np.abs(w).max()) > 0, i
            np.testing.assert_allclose(port_proj.to_jax_layout(g), w, rtol=0,
                                       atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=f"noise{i}, weight {weight}")


def test_adam_and_normalization_match_optax():
    """Five scheduled steps of the projector's update (Adam at _lr_schedule(t),
    lr 0 at step 0, then the noise normalisation) on fixed gradients, against
    optax.adam in inject_hyperparams, as TPUProjector runs it."""
    params = jax_params(7, TINY)
    _, w0, noises = pinned_inputs(params, TINY, 2, seed=7)
    rng = np.random.RandomState(8)
    grads = [[rng.randn(*w0.shape).astype(np.float32)]
             + [rng.randn(*n.shape).astype(np.float32) for n in noises] for _ in range(STEPS)]
    settings = jax_proj.ProjectorSettings(num_steps=STEPS)

    optimizer = optax.inject_hyperparams(optax.adam)(learning_rate=0.1)
    state = (jnp.asarray(w0), [jnp.asarray(n) for n in noises])
    opt_state = optimizer.init(state)
    for step, g in enumerate(grads):
        opt_state.hyperparams["learning_rate"] = jax_proj._lr_schedule(
            jnp.float32(step / STEPS), settings)
        updates, opt_state = optimizer.update((jnp.asarray(g[0]), [jnp.asarray(x) for x in g[1:]]),
                                              opt_state, state)
        w, planes = optax.apply_updates(state, updates)
        state = (w, jax_proj._normalize_noises(planes))

    projector = port_projector(params, TINY, num_steps=STEPS, dlatent_avg_samples=16)
    calls = iter(grads)

    def fixed_gradients(w, planes, target_proc, w_jitter, perceptual=None):
        g = next(calls)
        return (None, torch.zeros(2), None,
                [torch.from_numpy(g[0])] + nchw(g[1:]))

    projector._loss_and_gradients = fixed_gradients
    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    planes = [p.requires_grad_(True) for p in nchw(noises)]
    opt = torch.optim.Adam([w] + planes, lr=0.1)
    gen = torch.Generator().manual_seed(0)
    for step in range(STEPS):
        projector._step(w, planes, opt, None, step, gen, None, 0.0)
    want_w = np.asarray(state[0])
    np.testing.assert_allclose(w.detach().numpy(), want_w, rtol=0,
                               atol=1e-6 * float(np.abs(want_w).max()))
    for got, want in zip(planes, state[1]):
        want = np.asarray(want)
        np.testing.assert_allclose(port_proj.to_jax_layout(got), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# whole runs against TPUProjector
# ---------------------------------------------------------------------------


def record_run(projector, step_attr: str, targets, w0, noises, port: bool):
    """project_batch on the per-step loop with every history asked for; returns
    (results, per-step distances, latents, noises, images)."""
    distances, latents, planes, images = [], [], [], []
    original = getattr(projector, step_attr)

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        distances.append(np.asarray(out[0] if port else out[3]))
        return out

    setattr(projector, step_attr, recording)

    def callback(step, step_latents, step_noises, step_images):
        latents.append(step_latents)
        planes.append(step_noises)
        images.append(step_images)

    results = projector.project_batch(targets, step_callback=callback, want_step_images=True,
                                      per_step_noises=True, initial_latents=w0,
                                      initial_noises=noises, noise_factor=0.0)
    return results, distances, latents, planes, images


@pytest.fixture(scope="module", params=["off", "on"])
def trajectories(request):
    """The same pinned-start run of 5 steps, batch 3, 16px, on the standard
    path or (GANCE_TPU_PHASE1024=on) the phase path, in both packages."""
    params = jax_params(30, TINY)
    targets, w0, noises = pinned_inputs(params, TINY, BATCH, seed=31)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(PHASE_ENV, request.param)
        jp = jax_proj.TPUProjector(params, jax_g.GeneratorConfig(**TINY),
                                   settings=jax_proj.ProjectorSettings(num_steps=STEPS,
                                                                       dlatent_avg_samples=64))
        want = record_run(jp, "_step_fn", targets, w0, noises, port=False)
        want_eval = jp.evaluate_distance(np.stack([r.final_latents[0] for r in want[0]]),
                                         [np.concatenate(n) for n in zip(*[r.noises for r in want[0]])],
                                         targets)
        pp = port_projector(params, TINY, num_steps=STEPS, dlatent_avg_samples=64)
        got = record_run(pp, "_step", targets, w0, noises, port=True)
        got_eval = pp.evaluate_distance(np.stack([r.final_latents[0] for r in got[0]]),
                                        [np.concatenate(n) for n in zip(*[r.noises for r in got[0]])],
                                        targets)
    return request.param, got, want, got_eval, want_eval


def test_project_batch_matches_tpu_projector(trajectories):
    _, (results, dists, latents, planes, images), (j_results, j_dists, j_latents, j_planes,
                                                   j_images), got_eval, want_eval = trajectories
    assert len(dists) == len(j_dists) == len(latents) == len(j_latents) == STEPS
    for step in range(STEPS):
        np.testing.assert_allclose(dists[step], j_dists[step], rtol=1e-4, atol=0)
        norm_close(latents[step], j_latents[step], 1e-3)
        assert [p.shape for p in planes[step]] == [p.shape for p in j_planes[step]]
        norm_close(np.concatenate([p.ravel() for p in planes[step]]),
                   np.concatenate([p.ravel() for p in j_planes[step]]), 1e-3)
        assert images[step].dtype == np.uint8 and images[step].shape == j_images[step].shape
        diff = np.abs(images[step].astype(int) - j_images[step].astype(int))
        assert int(diff.max()) <= 1 and float(np.mean(diff == 0)) >= 0.99
    for got, want in zip(results, j_results):
        assert got.steps_run == want.steps_run == STEPS
        assert got.final_latents.shape == want.final_latents.shape == (1, 6, 16)
        assert np.all(got.final_latents == got.final_latents[:, :1])  # rows identical
        norm_close(got.final_latents, want.final_latents, 1e-3)
        assert got.noises_shapes == want.noises_shapes
        assert [n.shape for n in got.noises] == [n.shape for n in want.noises]
        norm_close(np.concatenate([n.ravel() for n in got.noises]),
                   np.concatenate([n.ravel() for n in want.noises]), 1e-3)
        assert abs(got.final_distance - want.final_distance) <= 1e-4 * want.final_distance
        diff = np.abs(got.final_image.astype(int) - want.final_image.astype(int))
        assert got.final_image.shape == want.final_image.shape and int(diff.max()) <= 1
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-4)


# At test_batch_composition_does_not_change_per_frame_result's seed, with the
# phase path off, frame 1's last Adam step meets an lrelu input within fp32
# rounding of its kink: the CPU's conv library sums a batch of one and a batch
# of three in other orders (oneDNN takes batches over one), a 4e-6 latent
# difference moves one w gradient component by 4e-3 of the gradient's scale,
# and the two runs end 1.2e-4 apart.
LAST_STEP_KINK = {"off": 1}


def _phase_convs_one_frame_at_a_time(real):
    """`ops/upfirdn2d.py::phase_convs` run on each frame alone, then stacked:
    a `Conv0_up` whose sums do not depend on the batch beside a frame."""

    def per_frame(x, w, factor):
        frames = [list(real(x[k:k + 1], w, factor)) for k in range(x.shape[0])]
        for items in zip(*frames):
            i, j, first = items[0]
            yield i, j, None if first is None else torch.cat([p for _, _, p in items])

    return per_frame


@pytest.mark.parametrize("phase", ["off", "on"])
def test_batch_composition_does_not_change_per_frame_result(monkeypatch, phase):
    """Frames optimize independently (the summed batch loss gives each frame
    its own gradient), with the stochastic inputs pinned (jitter 0, shared
    initial noise buffers). (1) A frame among other frames, at another
    position of a batch of the same size, follows its whole trajectory bit
    for bit: a convolution sums each frame alone, in a blocking set by the
    batch's shape. (2) A frame alone (batch 1) against the same frame in the
    batch of 3: every step's latents and the final latents within 1e-4, one
    step's loss gradients within 1e-4 of their scale, and the final distance
    within 1e-4. The frame of `LAST_STEP_KINK` is held so through its
    next-to-last step; its final latents are held within 1e-4 with the
    `Conv0_up` phase convs run one frame at a time, which takes the batch's
    blocking out of the one step that follows rounding."""
    monkeypatch.setenv(PHASE_ENV, phase)
    params = jax_params(32, TINY)
    targets, w0, noises = pinned_inputs(params, TINY, BATCH, seed=33)
    shared = [n[:1] for n in noises]  # (1, h, w, 1), broadcast over the batch
    projector = port_projector(params, TINY, num_steps=STEPS, dlatent_avg_samples=64)
    run = dict(want_step_images=False, initial_noises=shared, noise_factor=0.0)
    batched_steps = []
    batched = projector.project_batch(
        targets, initial_latents=w0, per_step_noises=False,
        step_callback=lambda s, lat, *_: batched_steps.append(lat.copy()), **run)
    others, others_w0, _ = pinned_inputs(params, TINY, BATCH, seed=34)
    planes = nchw([np.repeat(n, BATCH, axis=0) for n in shared])
    _, _, _, grads = projector._loss_and_gradients(
        torch.from_numpy(w0), planes, projector._target_proc(targets), torch.zeros(BATCH, 16))
    kinked = LAST_STEP_KINK.get(phase)
    for i in range(BATCH):
        j = (i + 1) % BATCH
        mixed, mixed_w0 = others.copy(), others_w0.copy()
        mixed[j], mixed_w0[j] = targets[i], w0[i]
        moved = projector.project_batch(mixed, initial_latents=mixed_w0, per_step_noises=False,
                                        **run)[j]
        np.testing.assert_array_equal(moved.final_latents, batched[i].final_latents)
        assert moved.final_distance == batched[i].final_distance

        _, _, _, alone = projector._loss_and_gradients(
            torch.from_numpy(w0[i:i + 1]), [p[i:i + 1] for p in planes],
            projector._target_proc(targets[i:i + 1]), torch.zeros(1, 16))
        for got, want in zip(alone, grads):
            want = want[i:i + 1]
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        single_steps = []
        single = projector.project(
            targets[i], initial_latents=w0[i],
            step_callback=lambda s, lat, *_: single_steps.append(lat.copy()), **run)
        assert len(single_steps) == len(batched_steps) == STEPS
        for step in range(STEPS - (i == kinked)):
            np.testing.assert_allclose(batched_steps[step][i], single_steps[step][0], atol=1e-4)
        if i != kinked:
            np.testing.assert_allclose(batched[i].final_latents, single.final_latents, atol=1e-4)
        assert abs(batched[i].final_distance - single.final_distance) < 1e-4
    if kinked is not None:
        monkeypatch.setattr(port_up, "phase_convs",
                            _phase_convs_one_frame_at_a_time(port_up.phase_convs))
        batched = projector.project_batch(targets, initial_latents=w0, per_step_noises=False,
                                          **run)
        single = projector.project(targets[kinked], initial_latents=w0[kinked], **run)
        np.testing.assert_allclose(batched[kinked].final_latents, single.final_latents,
                                   atol=1e-4)


def test_segmented_loop_equals_per_step_loop():
    """Latents histories alone run the segmented loop (segments of 4 and 2
    here); asking for noise histories forces a fetch every step. The callback
    sees the same steps and latents, bit for bit, and the same results."""
    params = jax_params(34, TINY)
    targets, _, _ = pinned_inputs(params, TINY, 2, seed=35)
    runs = {}
    for per_step in (False, True):
        projector = port_projector(params, TINY, num_steps=6, scan_segment=4,
                                   dlatent_avg_samples=64)
        seen = []
        results = projector.project_batch(
            targets, step_callback=lambda s, l, n, i: seen.append((s, l, [x.shape for x in n], i.shape)),
            want_step_images=False, per_step_noises=per_step)
        runs[per_step] = seen, results
    (seg_seen, seg_results), (step_seen, step_results) = runs[False], runs[True]
    assert [s[0] for s in seg_seen] == [s[0] for s in step_seen] == list(range(6))
    for a, b in zip(seg_seen, step_seen):
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2] and a[3] == b[3] == (2, 0, 0, 3)
    for a, b in zip(seg_results, step_results):
        np.testing.assert_array_equal(a.final_latents, b.final_latents)
        for x, y in zip(a.noises, b.noises):
            np.testing.assert_array_equal(x, y)
        assert a.final_distance == b.final_distance


@pytest.mark.parametrize("per_step", [False, True])
def test_convergence_stop_truncates_and_callback_steps_match(per_step):
    """A stop threshold every trace meets fires at the first check past the
    gate max(min_steps, 2 * window) = 4: segments are capped at the window (2)."""
    params = jax_params(36, TINY)
    targets, _, _ = pinned_inputs(params, TINY, 2, seed=37)
    projector = port_projector(params, TINY, num_steps=20, scan_segment=8, dlatent_avg_samples=64,
                               convergence_stop=10.0, convergence_window=2,
                               convergence_min_steps=3)
    steps = []
    results = projector.project_batch(targets, step_callback=lambda s, *_: steps.append(s),
                                      want_step_images=False, per_step_noises=per_step)
    assert [r.steps_run for r in results] == [4, 4]
    assert steps == list(range(4))
    projector.settings.convergence_stop = None
    assert projector.project_batch(targets, want_step_images=False)[0].steps_run == 20


def test_initial_starts_validated_eagerly():
    params = jax_params(38, TINY)
    projector = port_projector(params, TINY, num_steps=2, dlatent_avg_samples=8)
    targets, w0, noises = pinned_inputs(params, TINY, 2, seed=39)
    good = [n[:1] for n in noises]
    projector._step = None  # any step taken would fail with a TypeError
    for mutate in (
        lambda bufs: [b[..., 0] for b in bufs],  # rank 3
        lambda bufs: [np.repeat(b, 3, axis=0) for b in bufs],  # leading dim 3 != batch 2
        lambda bufs: [np.repeat(b, 2, axis=1) for b in bufs],  # wrong spatial dims
        lambda bufs: bufs[:-1],  # one buffer short
    ):
        with pytest.raises(ValueError, match="initial_noises"):
            projector.project_batch(targets, want_step_images=False, initial_noises=mutate(good))
    with pytest.raises(ValueError, match="initial_latents"):
        projector.project_batch(targets, initial_latents=np.zeros((3, TINY["dlatent_size"] + 1)))


def _model_axis_mesh():
    """A ('data', 'model') mesh with a 'model' axis of 2 on the CPU."""
    from gance_tpu_torch.parallel.mesh import Mesh, MeshDevice, _object_grid

    return Mesh(_object_grid([MeshDevice(0, torch.device("cpu"))] * 2, (1, 2)),
                ("data", "model"))


@pytest.mark.parametrize("kwargs,ported_by", [
    (dict(mesh=_model_axis_mesh()), "item 12"),
])
def test_unported_options_raise(kwargs, ported_by):
    """A tensor-parallel 'model' axis, which raised until ROADMAP `ported_by`
    ported it, projects: the params stay replicated, as JAX's projector
    keeps them under any mesh, and the data row's lead slot computes, so 3
    steps from a pinned start equal one device's bit for bit."""
    params = params_from_reference(jax_params(40, TINY))
    targets, w0, noises = pinned_inputs(jax_params(40, TINY), TINY, 2, seed=41)
    runs = []
    for extra in (kwargs, {}):
        projector = port_proj.Projector(
            params, port_g.GeneratorConfig(**TINY), device="cpu",
            settings=port_proj.ProjectorSettings(num_steps=3, dlatent_avg_samples=8), **extra)
        result = projector.project_batch(targets, want_step_images=False, initial_latents=w0,
                                         initial_noises=noises)
        runs.append(np.stack([r.final_latents for r in result]))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = params_from_reference(jax_params(40, TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_proj.Projector(params, port_g.GeneratorConfig(**TINY))


def test_watchdog_raises_on_slow_steps():
    params = jax_params(41, TINY)
    targets, _, _ = pinned_inputs(params, TINY, 1, seed=41)
    for scan in (1, 4):
        projector = port_proj.Projector(
            params_from_reference(params), port_g.GeneratorConfig(**TINY), device="cpu",
            expected_time_per_step=1e-9, first_step_timeout=1e-9,
            settings=port_proj.ProjectorSettings(num_steps=3, dlatent_avg_samples=8,
                                                 scan_segment=scan))
        with pytest.raises(RuntimeError, match="assuming a hang"):
            projector.project_batch(targets, want_step_images=False)


# ---------------------------------------------------------------------------
# the writer loop and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def network_and_video(tmp_path_factory):
    d = tmp_path_factory.mktemp("projector")
    params = jax_params(42, TINY)
    pkl = d / "net.pkl"
    save_generator_pickle(params, pkl)
    rng = np.random.RandomState(43)
    video = d / "source.mp4"
    write_source_to_disk_consume(
        iter([(rng.rand(16, 16, 3) * 255).astype(np.uint8) for _ in range(8)]), video,
        video_fps=30.0)
    return d, params, pkl, video


def read_file(reader_module, path):
    with reader_module.load_projection_file(path) as reader:
        attrs = reader.projection_attributes
        finals = [np.asarray(x) for x in reader.final_latents]
        targets = [np.asarray(x) for x in reader.target_images]
        images = [np.asarray(x) for x in reader.final_images]
        histories = [[np.asarray(s) for s in h] for h in reader.latents_histories]
        noises = [[np.asarray(s) for s in h] for h in reader.noises_histories]
    return attrs, finals, targets, images, histories, noises


def test_project_video_to_file_reads_back_through_both_readers(network_and_video):
    """The port's file, with every history on (the per-step loop), read and
    verified by JAX's reader and by the port's; its attributes and layout
    equal those of JAX's project_video_to_file on the same video and network."""
    d, params, pkl, video = network_and_video
    out, ref = d / "port.hdf5", d / "jax.hdf5"
    common = dict(path_to_video=video, path_to_network=pkl, steps_per_projection=3,
                  num_frames_to_project=3, projection_batch=2, latents_histories_enabled=True,
                  noises_histories_enabled=True, images_histories_enabled=True)
    port_writer.project_video_to_file(projection_file_path=out, device="cpu", **common)
    jax_writer.project_video_to_file(projection_file_path=ref, **common)
    jax_reader.verify_projection_file_assumptions(out)
    port_reader.verify_projection_file_assumptions(out)
    got = read_file(jax_reader, out)
    again = read_file(port_reader, out)
    want = read_file(jax_reader, ref)
    assert asdict(again[0]) == asdict(got[0])
    assert asdict(got[0]) == asdict(want[0])  # every attribute, noises_shapes in JAX's layout
    assert got[0].complete and got[0].projection_frame_count == 3
    assert got[0].noises_shapes == [(1,) + params["synthesis"]["noise"][n].shape[1:]
                                    for n in noise_names(params)]
    for a, b, c in zip(got[1:], again[1:], want[1:]):
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            if isinstance(x, list):
                assert len(x) == len(y) == len(z) == 3  # one entry per step
                assert all(np.array_equal(p, q) and p.shape == r.shape for p, q, r in zip(x, y, z))
            else:
                assert np.array_equal(x, y) and x.shape == z.shape and x.dtype == z.dtype
    for target, ref_target in zip(got[2], want[2]):
        np.testing.assert_array_equal(target, ref_target)  # the same frames of the same video


class MemoryWriter:
    """The ProjectionFileWriter surface, in memory: the writer loop's seam."""

    def __init__(self, path, attributes):
        self.attributes, self.frames, self.shapes = attributes, [], []
        self.frame_index = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def batch_frame_writers(self, count):
        import contextlib

        writer = self

        class Frame:
            def __init__(self):
                self.steps, self.final = [], None

            def record_step(self, step, latents, noises, image):
                self.steps.append((step, latents))

            def finish(self, target_image, final_latents, final_image):
                self.final = final_latents
                writer.frames.append(self)

        @contextlib.contextmanager
        def frames():
            yield [Frame() for _ in range(count)]
            self.frame_index += count

        return frames()

    def record_noises_shapes(self, shapes):
        self.shapes.append(list(shapes))


def test_write_loop_warm_start_passes_previous_finals():
    """With warm_start, every batch after the first starts at the last frame's
    final w with the jitter off; the first cold-starts."""
    calls = []

    class FakeProjector:
        def project_batch(self, frames, step_callback, want_step_images, per_step_noises,
                          initial_latents, noise_factor):
            calls.append((initial_latents, noise_factor, per_step_noises, want_step_images))
            latents = np.full((len(frames), 1, 4, 2), float(len(calls)), np.float32)
            step_callback(0, latents[:, 0], [np.zeros((len(frames), 4, 4, 1))],
                          np.zeros((len(frames), 0, 0, 3), np.uint8))
            return [port_proj.ProjectionResult(latents[i], frames[i], [], [(1, 4, 4, 1)], 0.0, 1)
                    for i in range(len(frames))]

    frames = iter([np.zeros((4, 4, 3), np.uint8)] * 5)
    holder = {}

    def factory(path, attributes):
        holder["writer"] = MemoryWriter(path, attributes)
        return holder["writer"]

    port_writer._projection_write_loop(factory, None, None, frames, 2, FakeProjector(), None, 5,
                                       True, False, False, True)
    assert [c[0] is None for c in calls] == [True, False, False]
    assert [c[1] for c in calls] == [None, 0.0, 0.0]
    np.testing.assert_array_equal(calls[1][0], np.full((2, 2), 1.0, np.float32))
    writer = holder["writer"]
    assert writer.frame_index == 5 and len(writer.frames) == 5
    assert all(len(f.steps) == 1 for f in writer.frames)


def test_cli_videos_and_directory_with_vgg_weights(network_and_video, monkeypatch):
    """--vgg-weights reaches the projector, --device selects the CPU, and the
    files verify through JAX's verifier (latents histories only: the
    segmented loop)."""
    from click.testing import CliRunner

    from gance_tpu.projection.vgg_import import fabricate_nvlabs_lpips_variables
    from gance_tpu_torch.cli.project_video_to_file import cli

    d, _, pkl, video = network_and_video
    vgg = d / "vgg16_zhang_perceptual.pkl"
    _write_nvlabs_lpips_pickle(vgg, fabricate_nvlabs_lpips_variables(np.random.RandomState(5)))
    seen = []
    original = port_proj.Projector.__init__

    def spy(self, *args, **kwargs):
        seen.append((kwargs.get("vgg_weights_path"), kwargs.get("device")))
        original(self, *args, **kwargs)

    monkeypatch.setattr(port_proj.Projector, "__init__", spy)
    out = d / "cli.hdf5"
    common = ["--path-to-network", str(pkl), "--steps-per-projection", "2",
              "--num-frames-to-project", "1", "--device", "cpu"]
    result = CliRunner().invoke(cli, ["videos", *common, "--vgg-weights", str(vgg),
                                      "--video-output", str(video), str(out)])
    assert result.exit_code == 0, result.output
    assert seen == [(vgg, "cpu")]
    jax_reader.verify_projection_file_assumptions(out)
    with jax_reader.load_projection_file(out) as reader:
        assert [len(list(h)) for h in reader.latents_histories] == [2]

    videos_dir = d / "videos"
    videos_dir.mkdir()
    os.link(video, videos_dir / "clip.mp4")
    result = CliRunner().invoke(cli, ["directory", *common, "--directory-of-videos",
                                      str(videos_dir), "--output-file-directory",
                                      str(d / "outs")])
    assert result.exit_code == 0, result.output
    port_reader.verify_projection_file_assumptions(d / "outs" / "projection_clip.hdf5")


@pytest.mark.parametrize("extra,item", [
    (["--data-parallel", "2"], "item 12"),
    (["--dist-coordinator", "localhost:1234"], "item 12"),
    (None, "item 13"),
])
def test_cli_unported_modes_raise_usage_errors(network_and_video, extra, item, monkeypatch):
    """The modes once unported work now. `visualize-final-latents` (item 13)
    writes the triptych video, a frame per projected frame. The
    multi-device options (item 12, part 1) keep JAX's errors: --data-parallel
    2 over one CPU slot is JAX's ValueError (not divisible) and projects over
    two; a partial --dist-* triple is JAX's usage error."""
    from click.testing import CliRunner

    from gance_tpu_torch.cli.project_video_to_file import cli
    from tests.test_torch_media import read_avi

    d, _, pkl, video = network_and_video
    if extra is None:
        projection = d / "triptych.hdf5"
        attrs = port_writer.ProjectionAttributes(
            version_number=port_writer.LATEST_VERSION, complete=True,
            original_target_path=str(video), original_width_height=(16, 16),
            projection_width_height=(16, 16), target_md5_hash="0" * 32,
            original_network_path=str(pkl), network_md5_hash="0" * 32, steps_in_projection=1,
            noises_shapes=np.nan, latents_histories_enabled=False,
            noises_histories_enabled=False, images_histories_enabled=False, original_fps=30.0,
            projection_fps=30.0, original_frame_count=3, projection_frame_count=3)
        rng = np.random.RandomState(44)
        with port_writer.ProjectionFileWriter(projection, attrs) as writer:
            for _ in range(3):
                target = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
                with writer.frame_writer() as frame:
                    frame.finish(target, np.tile(rng.randn(16).astype(np.float32), (1, 6, 1)),
                                 target)
        monkeypatch.setenv("GANCE_TPU_EGRESS", "raw-spill")
        result = CliRunner().invoke(cli, [
            "visualize-final-latents", "--projection-file", str(projection), "--output-path",
            str(d / "viz.avi"), "--video-height", "40"])
        assert result.exit_code == 0, result.output + repr(result.exception)
        assert read_avi(d / "viz.avi")[0].shape == (3, 40, 3 * 40, 3)
        return
    args = ["videos", "--path-to-network", str(pkl), "--device", "cpu", *extra,
            "--steps-per-projection", "2", "--num-frames-to-project", "2",
            "--video-output", str(video), str(d / "never.hdf5")]
    result = CliRunner().invoke(cli, args)
    if extra[0] == "--data-parallel":
        assert isinstance(result.exception, ValueError), result.output
        assert "not divisible by dp=2" in str(result.exception)
        assert not (d / "never.hdf5").exists()
        cpu_slots(2, monkeypatch)
        result = CliRunner().invoke(cli, args)
        assert result.exit_code == 0, result.output
        port_reader.verify_projection_file_assumptions(d / "never.hdf5")
        (d / "never.hdf5").unlink()
        return
    assert result.exit_code == 2, result.output
    assert "must be given together" in result.output
    assert not (d / "never.hdf5").exists()
