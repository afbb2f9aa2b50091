"""
The port's network metrics (gance_tpu_torch/metrics) against gance_tpu's, on
the CPU, at tests/test_metrics.py's 32px MODEL (params carried over by
`params_from_reference`, the same random-VGG weights):

  * `FeatureMoments` and `gaussian_frechet_distance` (copies, numpy float64)
    against JAX's on seeded inputs, to 1e-12;
  * `pooled_vgg_features` and `slerp` against JAX's, to 1e-5;
  * PPL chunk distances with JAX's own draws handed in (the `pair_draws`
    seam), in w and z, full and end, plain, cropped and truncated. Measured
    worst relative error 6.1e-5 at epsilon 1e-2 and 4.2e-3 at 1e-4 (the
    division by epsilon^2 amplifies fp32 rounding of the two syntheses), held
    to 2e-4 and 1e-2;
  * `perceptual_path_length` and `frechet_distance_network_vs_images` end to
    end with JAX's draws, and the same seed repeating bit for bit; bf16 PPL
    only finite and within 10x of JAX's bf16 (epsilon steps fall below bf16's
    resolution);
  * option validation and both Fréchet warnings.
"""

import logging

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gance_tpu.metrics import frechet as jax_frechet  # noqa: E402
from gance_tpu.metrics import ppl as jax_ppl  # noqa: E402
from gance_tpu.models import stylegan2 as jax_g  # noqa: E402
from gance_tpu.projection.lpips import random_vgg_params  # noqa: E402
from gance_tpu_torch.metrics import frechet as port_frechet  # noqa: E402
from gance_tpu_torch.metrics import ppl as port_ppl  # noqa: E402
from gance_tpu_torch.models import stylegan2 as port_g  # noqa: E402
from gance_tpu_torch.models.convert import params_from_reference  # noqa: E402
from gance_tpu_torch.projection.lpips import vgg_params_to_device  # noqa: E402
from gance_tpu_torch.utils.device import params_to_device  # noqa: E402
from tests.torch_threads import capped_threads  # noqa: E402,F401

MODEL_KW = dict(resolution=32, fmap_base=256, fmap_max=32, latent_size=32, dlatent_size=32,
                mapping_layers=2, mapping_fmaps=32)  # tests/test_metrics.py's MODEL
JAX_MODEL = jax_g.GeneratorConfig(**MODEL_KW)
PORT_MODEL = port_g.GeneratorConfig(**MODEL_KW)
CPU = torch.device("cpu")
EPS_TOLERANCE = {1e-2: 2e-4, 1e-4: 1e-2}


@pytest.fixture(scope="module")
def jax_network():
    return jax_g.init_generator_params(jax.random.PRNGKey(0), JAX_MODEL)


@pytest.fixture(scope="module")
def port_network(jax_network):
    return params_from_reference(jax_network)


@pytest.fixture(scope="module")
def perceptual():
    return random_vgg_params(seed=0)


def jax_pair_draws(seed: int, sampling: str):
    """JAX's PPL draws of chunk i (gance_tpu/metrics/ppl.py:99-103)."""

    def draw(chunk: int, batch: int):
        z_key, t_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), chunk))
        z = np.asarray(jax.random.normal(z_key, (batch * 2, MODEL_KW["latent_size"])))
        if sampling == "full":
            return z, np.asarray(jax.random.uniform(t_key, (batch, 1)))
        return z, np.zeros((batch, 1), np.float32)

    return draw


def jax_latent_draws(seed: int):
    """JAX's Fréchet draws of chunk i (gance_tpu/metrics/frechet.py:148)."""

    def draw(chunk: int, batch: int):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), chunk)
        return np.asarray(jax.random.normal(key, (batch, MODEL_KW["latent_size"])))

    return draw


def two_block_features(monkeypatch) -> None:
    """Make VGG blocks 0-1 (D = 64 + 128 = 192) both packages' default
    extractor. The streams, moments and distance run the same code, and
    scipy's sqrtm of a 192-dim product takes milliseconds where 1472 dims
    take seconds; tests/test_torch_metrics_cli.py keeps all 1472 through
    both CLIs."""
    jax_fn, port_fn = jax_frechet.pooled_vgg_features, port_frechet.pooled_vgg_features
    monkeypatch.setattr(jax_frechet, "pooled_vgg_features", lambda p, x: jax_fn(p, x, (0, 1)))
    monkeypatch.setattr(port_frechet, "pooled_vgg_features", lambda p, x: port_fn(p, x, (0, 1)))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


# ---------------------------------------------------------------------------
# Fréchet math (copies of JAX's numpy code)
# ---------------------------------------------------------------------------


def test_feature_moments_match_jax():
    data = np.random.RandomState(2).randn(37, 6)
    ours, theirs = port_frechet.FeatureMoments(dim=6), jax_frechet.FeatureMoments(dim=6)
    for chunk in np.array_split(data, [5, 9, 30]):
        ours.update(chunk)
        theirs.update(chunk)
    (mu, cov), (mu_j, cov_j) = ours.finalize(), theirs.finalize()
    assert ours.count == theirs.count == 37
    np.testing.assert_allclose(mu, mu_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(cov, cov_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(cov, np.cov(data, rowvar=False), rtol=1e-10)


def test_feature_moments_shape_guard():
    moments = port_frechet.FeatureMoments(dim=3)
    with pytest.raises(ValueError):
        moments.update(np.zeros((4, 2)))
    with pytest.raises(ValueError):
        port_frechet.FeatureMoments(dim=3).finalize()


def _gaussians(case: str):
    rng = np.random.RandomState(1)
    if case == "identical":
        mu = rng.randn(6)
        a = rng.randn(6, 6)
        cov = a @ a.T + np.eye(6)
        return mu, cov, mu, cov
    if case == "diagonal":
        return rng.randn(5), np.diag(rng.rand(5) + 0.5), rng.randn(5), np.diag(rng.rand(5) + 0.5)
    a, b = rng.randn(8, 8), rng.randn(8, 8)
    return rng.randn(8), a @ a.T + np.eye(8), rng.randn(8), b @ b.T + 0.1 * np.eye(8)


@pytest.mark.parametrize("case", ["identical", "diagonal", "full"])
def test_gaussian_frechet_distance_matches_jax(case):
    args = _gaussians(case)
    got = port_frechet.gaussian_frechet_distance(*args)
    want = jax_frechet.gaussian_frechet_distance(*args)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    if case == "diagonal":
        mu_a, cov_a, mu_b, cov_b = args
        closed = np.sum((mu_a - mu_b) ** 2) + np.sum(
            (np.sqrt(np.diag(cov_a)) - np.sqrt(np.diag(cov_b))) ** 2)
        assert got == pytest.approx(closed, rel=1e-9)


def test_frechet_complex_sqrtm_warns(caplog):
    mu = np.zeros(2)
    indefinite = np.diag([-1.0, 1.0])  # sqrtm(diag(-1, 1)) = diag(i, 1)
    with caplog.at_level(logging.WARNING, logger="gance_tpu_torch"):
        value = port_frechet.gaussian_frechet_distance(mu, np.eye(2), mu, indefinite)
    assert value == jax_frechet.gaussian_frechet_distance(mu, np.eye(2), mu, indefinite)
    assert any("complex" in rec.message for rec in caplog.records)


# ---------------------------------------------------------------------------
# Features and slerp
# ---------------------------------------------------------------------------


def test_pooled_vgg_features_match_jax(perceptual):
    images = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_frechet.pooled_vgg_features(perceptual, jnp.asarray(images)))
    got = port_frechet.pooled_vgg_features(vgg_params_to_device(perceptual, CPU),
                                           torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 64 + 128 + 256 + 512 + 512)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_slerp_matches_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(4, 8).astype(np.float32), rng.randn(4, 8).astype(np.float32)
    for t in (np.zeros((4, 1)), np.ones((4, 1)), rng.rand(4, 1)):
        t = t.astype(np.float32)
        want = np.asarray(jax_ppl.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
        got = port_ppl.slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# PPL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,epsilon", [("plain", 1e-2), ("plain", 1e-4), ("crop", 1e-4),
                                             ("truncated", 1e-2)])
@pytest.mark.parametrize("sampling", ["full", "end"])
@pytest.mark.parametrize("space", ["w", "z"])
def test_ppl_chunk_matches_jax(jax_network, port_network, perceptual, space, sampling, variant,
                               epsilon):
    crop, psi = variant == "crop", (0.7 if variant == "truncated" else None)
    chunk_fn = jax_ppl._build_chunk_fn(JAX_MODEL, space, sampling, epsilon, crop, psi,
                                       jnp.float32)
    want = np.asarray(chunk_fn(jax_network, perceptual,
                               jax.random.fold_in(jax.random.PRNGKey(7), 0), 4))
    z, t = jax_pair_draws(7, sampling)(0, 4)
    with torch.inference_mode():
        got = port_ppl.chunk_distances(
            params_to_device(port_network, CPU), vgg_params_to_device(perceptual, CPU),
            torch.tensor(z), torch.tensor(t), PORT_MODEL, space, epsilon, crop, psi,
            torch.float32).numpy()
    assert got.shape == want.shape == (4,)
    assert np.all(np.isfinite(got)) and np.all(want > 0)
    assert rel_err(got, want) <= EPS_TOLERANCE[epsilon]


@pytest.mark.parametrize("space", ["w", "z"])
def test_perceptual_path_length_matches_jax(jax_network, port_network, perceptual, space):
    kwargs = dict(num_samples=6, batch_size=4, space=space, sampling="full", epsilon=1e-2,
                  seed=7)
    want = jax_ppl.perceptual_path_length(jax_network, JAX_MODEL, perceptual, **kwargs)
    got = port_ppl.perceptual_path_length(port_network, PORT_MODEL, perceptual, device="cpu",
                                          pair_draws=jax_pair_draws(7, "full"), **kwargs)
    assert isinstance(got, port_ppl.PPLResult)
    assert got.ppl == pytest.approx(want.ppl, rel=EPS_TOLERANCE[1e-2])
    for field in ("num_samples", "num_filtered", "space", "sampling", "epsilon", "crop"):
        assert getattr(got, field) == getattr(want, field), field


def test_bf16_ppl_is_finite_and_of_jax_bf16_order(jax_network, port_network, perceptual):
    """bf16: epsilon * (w1 - w0) lies below bf16's resolution in many entries
    of w+, so the two endpoints' images differ by rounding as much as by the
    step; PPL is held only to being finite and within a factor of 10 of JAX's
    bf16 PPL on the same draws."""
    kwargs = dict(num_samples=4, batch_size=4, epsilon=1e-2, seed=7)
    want = jax_ppl.perceptual_path_length(jax_network, JAX_MODEL, perceptual,
                                          compute_dtype=jnp.bfloat16, **kwargs)
    got = port_ppl.perceptual_path_length(port_network, PORT_MODEL, perceptual,
                                          compute_dtype=torch.bfloat16, device="cpu",
                                          pair_draws=jax_pair_draws(7, "full"), **kwargs)
    assert np.isfinite(got.ppl) and got.ppl > 0 and np.isfinite(want.ppl) and want.ppl > 0
    assert 0.1 <= got.ppl / want.ppl <= 10.0


def test_ppl_repeats_bit_for_bit_and_follows_the_seed(port_network, perceptual):
    kwargs = dict(num_samples=6, batch_size=4, epsilon=1e-2, device="cpu")
    a = port_ppl.perceptual_path_length(port_network, PORT_MODEL, perceptual, seed=7, **kwargs)
    b = port_ppl.perceptual_path_length(port_network, PORT_MODEL, perceptual, seed=7, **kwargs)
    c = port_ppl.perceptual_path_length(port_network, PORT_MODEL, perceptual, seed=8, **kwargs)
    assert np.isfinite(a.ppl) and a.ppl > 0 and a.ppl == b.ppl
    assert c.ppl != a.ppl
    assert 0 < a.num_filtered <= 6


def test_default_draws_are_functions_of_seed_and_chunk():
    draw = port_ppl.default_pair_draws(3, 16, "full")
    (z0, t0), (z0b, t0b), (z1, _) = draw(0, 4), draw(0, 4), draw(1, 4)
    assert z0.shape == (8, 16) and t0.shape == (4, 1) and z0.dtype == np.float32
    assert np.array_equal(z0, z0b) and np.array_equal(t0, t0b) and not np.array_equal(z0, z1)
    assert np.all((t0 >= 0) & (t0 < 1))
    _, t_end = port_ppl.default_pair_draws(3, 16, "end")(0, 4)
    assert not t_end.any()
    other = port_ppl.default_pair_draws(4, 16, "full")(0, 4)[0]
    assert not np.array_equal(z0, other)
    z = port_frechet.default_latent_draws(3, 16)(0, 4)
    assert z.shape == (4, 16) and np.array_equal(z, port_frechet.default_latent_draws(3, 16)(0, 4))


def test_ppl_validates_options(port_network, perceptual):
    for bad in (dict(space="bogus"), dict(sampling="bogus")):
        with pytest.raises(ValueError):
            port_ppl.perceptual_path_length(port_network, PORT_MODEL, perceptual, device="cpu",
                                            **bad)


# ---------------------------------------------------------------------------
# Fréchet end to end
# ---------------------------------------------------------------------------


def _image_folder(path, count, seed):
    from PIL import Image

    path.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(count):
        Image.fromarray(rng.randint(0, 255, size=(40, 40, 3), dtype=np.uint8)).save(
            path / f"r_{i}.png")
    return path


def _recording_hook(store):
    def hook(name, stream):
        for features in stream:
            store.setdefault(name, []).append(np.asarray(features))
            yield features

    return hook


def test_frechet_matches_jax(monkeypatch, jax_network, port_network, perceptual, tmp_path):
    """The default path with VGG blocks 0-1 (`two_block_features`): each
    stream's features within 1e-5 of JAX's (the fake side quantises to uint8
    first; the two renders land on the same steps here), and the distance to
    1e-4 relative: with 6 samples the covariances are rank-deficient and
    sqrtm amplifies the feature differences (4.9e-6 measured at 1472 dims in
    tests/test_torch_metrics_cli.py)."""
    two_block_features(monkeypatch)
    real = _image_folder(tmp_path / "real", 6, 9)
    kwargs = dict(num_samples=6, batch_size=4, seed=5)
    jax_feats, port_feats = {}, {}
    want = jax_frechet.frechet_distance_network_vs_images(
        jax_network, JAX_MODEL, perceptual, real, feature_stream_hook=_recording_hook(jax_feats),
        **kwargs)
    got = port_frechet.frechet_distance_network_vs_images(
        port_network, PORT_MODEL, perceptual, real, device="cpu",
        feature_stream_hook=_recording_hook(port_feats), latent_draws=jax_latent_draws(5),
        **kwargs)
    for side in ("fake", "real"):
        a, b = np.concatenate(port_feats[side]), np.concatenate(jax_feats[side])
        assert a.shape == b.shape == (6, 192)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))
    assert {k: v for k, v in got.items() if k != "distance"} == {
        k: v for k, v in want.items() if k != "distance"}
    assert got["distance"] == pytest.approx(want["distance"], rel=1e-4)


def _mean_rgb_jax(params, images):
    del params
    return jnp.mean(images, axis=(1, 2))


def _mean_rgb_port(params, images):
    del params
    return images.mean(dim=(1, 2))


def test_frechet_pluggable_feature_fn_matches_jax(jax_network, port_network, perceptual,
                                                  tmp_path):
    real = _image_folder(tmp_path / "real", 8, 9)
    kwargs = dict(num_samples=8, batch_size=4, seed=2)
    want = jax_frechet.frechet_distance_network_vs_images(
        jax_network, JAX_MODEL, perceptual, real, feature_fn=_mean_rgb_jax, **kwargs)
    got = port_frechet.frechet_distance_network_vs_images(
        port_network, PORT_MODEL, perceptual, real, feature_fn=_mean_rgb_port, device="cpu",
        latent_draws=jax_latent_draws(2), **kwargs)
    assert got["feature_dim"] == want["feature_dim"] == 3
    assert got["note"] == want["note"] and "custom feature_fn" in got["note"]
    assert got["distance"] == pytest.approx(want["distance"], rel=1e-5)


def test_frechet_defaults_to_untruncated_and_repeats(port_network, perceptual, tmp_path):
    real = _image_folder(tmp_path / "real", 8, 11)

    def run(**kwargs):
        return port_frechet.frechet_distance_network_vs_images(
            port_network, PORT_MODEL, perceptual, real, num_samples=8, batch_size=4,
            feature_fn=_mean_rgb_port, device="cpu", **kwargs)["distance"]

    default = run()
    assert default == run()  # the same seed, bit for bit
    assert default == pytest.approx(run(truncation_psi=1.0), rel=1e-6)
    assert default != pytest.approx(run(truncation_psi=0.2), rel=1e-6)
    assert default != run(seed=1)


def test_frechet_warns_on_rank_deficient_sample_count(port_network, perceptual, tmp_path,
                                                      caplog):
    real = _image_folder(tmp_path / "real", 3, 13)
    with caplog.at_level(logging.WARNING, logger="gance_tpu_torch"):
        result = port_frechet.frechet_distance_network_vs_images(
            port_network, PORT_MODEL, perceptual, real, num_samples=3, batch_size=4,
            feature_fn=_mean_rgb_port, device="cpu")
    assert np.isfinite(result["distance"])
    assert any("rank-deficient" in rec.message for rec in caplog.records)


def test_frechet_needs_two_images(port_network, perceptual, tmp_path):
    real = _image_folder(tmp_path / "real", 1, 1)
    with pytest.raises(ValueError, match="at least 2 images"):
        port_frechet.frechet_distance_network_vs_images(
            port_network, PORT_MODEL, perceptual, real, device="cpu")
