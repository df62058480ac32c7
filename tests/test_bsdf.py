"""BSDF math validation (SURVEY.md §4 tier 1): GGX NDF normalisation,
importance-sampling distribution, geometry/Fresnel bounds."""

import jax.numpy as jnp
import numpy as np

from pathtracer.render import bsdf
from pathtracer.utils import rng


def hemisphere_dirs(n, seed=0):
    """Uniform hemisphere samples around +y with pdf 1/(2pi)."""
    rs = np.random.RandomState(seed)
    u1, u2 = rs.rand(n), rs.rand(n)
    y = u1
    r = np.sqrt(np.maximum(0, 1 - y * y))
    phi = 2 * np.pi * u2
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1).astype(np.float32)


def test_ggx_ndf_normalisation():
    # White-furnace property of the NDF: integral of D(m) (n.m) dm over the
    # hemisphere == 1 for any roughness.
    n = jnp.asarray([0.0, 1.0, 0.0])
    m = jnp.asarray(hemisphere_dirs(400_000))
    for alpha in (0.1, 0.3, 0.7, 1.0):
        d = bsdf.d_ggx(n, m, jnp.float32(alpha))
        cos = jnp.maximum(m[:, 1], 0.0)
        integral = float(jnp.mean(d * cos) * 2.0 * jnp.pi)
        assert abs(integral - 1.0) < 0.02, (alpha, integral)


def test_ggx_importance_sample_matches_ndf():
    # Sampled half-vectors follow pdf D(m) (n.m): verify E[1/(D cos)] over
    # samples equals the hemisphere area ratio... simpler: chi-square on
    # cos(theta) histogram vs the analytic marginal.
    alpha = 0.5
    n = 200_000
    seeds = rng.make_seeds(jnp.arange(n), 0, 0)
    seeds, u1 = rng.uniform(seeds)
    seeds, u2 = rng.uniform(seeds)
    h = bsdf.ggx_importance_sample(u1, u2, jnp.float32(alpha))
    cos_t = np.asarray(h[:, 1])
    assert np.all(cos_t >= 0)
    # analytic CDF of cos^2: for GGX half-vector sampling,
    # cos_theta = sqrt((1-u)/(1+(a^2-1)u)) => u = (1-c^2)/(1+(a^2-1)c^2 ... )
    a2 = alpha * alpha
    u_back = (1 - cos_t**2) / (cos_t**2 * (a2 - 1) + 1)
    # u_back must be ~Uniform(0,1)
    hist, _ = np.histogram(u_back, bins=32, range=(0, 1))
    expected = n / 32
    chi2 = ((hist - expected) ** 2 / expected).sum()
    assert chi2 < 31 + 5 * np.sqrt(2 * 31)


def test_smith_g_bounds():
    rs = np.random.RandomState(1)
    n = jnp.asarray([0.0, 1.0, 0.0])
    v = jnp.asarray(hemisphere_dirs(1000, seed=2))
    l = jnp.asarray(hemisphere_dirs(1000, seed=3))
    for alpha in (0.05, 0.5, 1.0):
        g = np.asarray(bsdf.g_smith(jnp.float32(alpha), n, v, l))
        assert np.all(g >= 0) and np.all(g <= 1 + 1e-5)


def test_fresnel_schlick_limits():
    f0 = jnp.asarray([[0.04, 0.04, 0.04]])
    # normal incidence -> F0; grazing -> 1
    at0 = np.asarray(bsdf.fresnel_schlick(jnp.asarray([1.0]), f0))
    at90 = np.asarray(bsdf.fresnel_schlick(jnp.asarray([0.0]), f0))
    np.testing.assert_allclose(at0, 0.04, atol=1e-6)
    np.testing.assert_allclose(at90, 1.0, atol=1e-6)


def test_fresnel_scalar_matches_reference_form():
    # r0 = ((1-n)/(1+n))^2; at cos=1 -> r0
    got = float(bsdf.fresnel_schlick_scalar(jnp.asarray(1.0), 1.5))
    np.testing.assert_allclose(got, ((1 - 1.5) / (1 + 1.5)) ** 2, rtol=1e-6)


def test_ggx_pdf_positive():
    d = jnp.asarray([1.0, 2.0])
    ndoth = jnp.asarray([0.5, 0.9])
    vdoth = jnp.asarray([0.5, 0.7])
    p = np.asarray(bsdf.ggx_pdf(d, ndoth, vdoth))
    assert np.all(p > 0)


def test_ggx_delta_lobe_never_inf():
    # Regression (round 4): at tiny alpha with n.h ~= 1, the NDF
    # denominator ndoth^2*(a2-1)+1 can round to EXACTLY 0 in f32,
    # making D = inf — and brdf_specular/ggx_pdf, whose D should
    # cancel, evaluate inf/inf = NaN.  The base estimator masks such
    # lanes (brdf-length check, reference cu:859) but the NEE light
    # arm consumes brdf_combined unmasked, so the NaN reached radiance
    # on the high-poly scene (radiance sum=nan).
    n = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    # Search a small grid of (alpha, ndoth) f32 values around the
    # cancellation for denom == 0; d_ggx accepts unnormalised h, so
    # ndoth is driven directly through h = ndoth * n.
    found_zero = False
    for rough in np.linspace(0.015, 0.05, 30, dtype=np.float32):
        a2 = np.float32(rough * rough) * np.float32(rough * rough)
        base = np.float32(np.sqrt(1.0 / (1.0 - float(a2))))
        for k in range(-4, 5):
            ndoth = np.float32(base) + np.float32(k) * np.spacing(base)
            inner = np.float32(ndoth * ndoth) * np.float32(a2 - np.float32(1.0)) + np.float32(1.0)
            if inner == 0.0:
                found_zero = True
            h = jnp.asarray([0.0, float(ndoth), 0.0], jnp.float32)
            alpha = jnp.float32(rough * rough)
            d = bsdf.d_ggx(n, h, alpha)
            spdf = bsdf.ggx_pdf(d, jnp.maximum(jnp.float32(ndoth), 1e-10), jnp.float32(1.0))
            ratio = d / jnp.maximum(spdf, 1e-20)
            assert np.isfinite(float(d)), (rough, float(ndoth))
            assert np.isfinite(float(ratio)), (rough, float(ndoth))
    # The grid must actually hit the exact-zero cancellation, otherwise
    # this test is vacuous.
    assert found_zero
