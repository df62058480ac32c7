"""Film / post-chain scalar tests against the reference constants
(reference optixSphere.cu:266-277, 400-435)."""

import jax.numpy as jnp
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.render import film


def ref_tonemap(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F) - E / F


def test_tonemap_matches_reference_polynomial():
    x = np.linspace(0.0, 20.0, 257, dtype=np.float32)
    got = np.asarray(film.aces_fit_tonemap(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref_tonemap(x), rtol=1e-5, atol=1e-7)


def test_tonemap_zero():
    # At x=0: D*E/(D*F) - E/F = 0 exactly.
    assert abs(float(film.aces_fit_tonemap(jnp.asarray(0.0)))) < 1e-6


def test_accumulate_first_frame():
    prev = jnp.ones((4, 4, 3)) * 9.0
    new = jnp.ones((4, 4, 3)) * 2.0
    out = film.accumulate(prev, new, 0)
    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_accumulate_running_mean():
    # Accumulating k frames of values v_1..v_k yields their mean.
    rs = np.random.RandomState(0)
    frames = rs.rand(8, 2, 2, 3).astype(np.float32)
    accum = jnp.zeros((2, 2, 3))
    for k, f in enumerate(frames):
        accum = film.accumulate(accum, jnp.asarray(f), k)
    np.testing.assert_allclose(np.asarray(accum), frames.mean(axis=0), rtol=1e-4)


def test_post_process_chain():
    cfg = RenderConfig(srgb_output=False)
    x = jnp.asarray([[1.0, 1.0, 1.0]], jnp.float32)
    got = np.asarray(film.post_process(x, cfg))[0, 0]
    # Hand-computed: exposure exp2(-0.5), tonemap, clamp, gamma, contrast.
    v = 1.0 * 2.0 ** (-0.5)
    v = ref_tonemap(v)
    v = np.clip(v, 0, 1) ** (1 / 2.2)
    v = np.clip(0.5 + 1.25 * (v - 0.5), 0, 1)
    np.testing.assert_allclose(got, v, rtol=1e-4)


def test_srgb_roundtrip_monotonic():
    x = jnp.linspace(0.0, 1.0, 100)
    y = np.asarray(film.to_srgb(x))
    assert np.all(np.diff(y) > 0)
    assert y[0] >= 0.0 and y[-1] <= 1.0 + 1e-6


def test_to_uint8():
    x = jnp.asarray([0.0, 0.5, 1.0, 2.0, -1.0])
    got = np.asarray(film.to_uint8(x))
    np.testing.assert_array_equal(got, [0, 128, 255, 255, 0])
