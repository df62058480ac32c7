"""RNG statistics: uniformity, decorrelation, determinism (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np

from pathtracer.utils import rng


def test_uniform_range_and_mean():
    seeds = rng.make_seeds(jnp.arange(10000), 0, 0)
    _, u = rng.uniform(seeds)
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1.0 / 12.0) < 0.005


def test_uniform_chi_square():
    seeds = rng.make_seeds(jnp.arange(65536), 1, 7)
    seeds, u = rng.uniform(seeds)
    hist, _ = np.histogram(np.asarray(u), bins=64, range=(0, 1))
    expected = 65536 / 64
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    # 63 dof: mean 63, std ~11.2; 5-sigma bound.
    assert chi2 < 63 + 5 * np.sqrt(2 * 63)


def test_per_pixel_decorrelation():
    # Neighbouring pixels must not correlate (the reference's unhashed
    # seeding visibly correlates them; ours must not).
    n = 4096
    s_a = rng.make_seeds(jnp.arange(n), 0, 0)
    s_b = rng.make_seeds(jnp.arange(n) + 1, 0, 0)
    _, ua = rng.uniform(s_a)
    _, ub = rng.uniform(s_b)
    corr = np.corrcoef(np.asarray(ua), np.asarray(ub))[0, 1]
    assert abs(corr) < 0.05


def test_determinism_and_counter_independence():
    s1 = rng.make_seeds(jnp.asarray([5]), jnp.asarray([3]), jnp.asarray([2]))
    s2 = rng.make_seeds(jnp.asarray([5]), jnp.asarray([3]), jnp.asarray([2]))
    assert np.asarray(s1) == np.asarray(s2)
    s3 = rng.make_seeds(jnp.asarray([5]), jnp.asarray([4]), jnp.asarray([2]))
    assert np.asarray(s1) != np.asarray(s3)


def test_random_in_unit_sphere():
    seeds = rng.make_seeds(jnp.arange(2048), 0, 0)
    new_seeds, p = rng.random_in_unit_sphere(seeds)
    r2 = np.sum(np.asarray(p) ** 2, axis=-1)
    assert np.all(r2 < 1.0)
    # Seeds advanced (at least 3 draws each).
    assert not np.any(np.asarray(new_seeds) == np.asarray(seeds))
    # Mean should be near origin.
    assert np.linalg.norm(np.asarray(p).mean(axis=0)) < 0.05


def test_cosine_hemisphere_distribution():
    seeds = rng.make_seeds(jnp.arange(65536), 0, 3)
    seeds, u1 = rng.uniform(seeds)
    seeds, u2 = rng.uniform(seeds)
    d = np.asarray(rng.cosine_sample_hemisphere(u1, u2))
    # Cosine axis is +y (reference convention).
    assert np.all(d[:, 1] >= 0.0)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # E[cos theta] = 2/3 for pdf = cos/pi.
    assert abs(d[:, 1].mean() - 2.0 / 3.0) < 0.01
