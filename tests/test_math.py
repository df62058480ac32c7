"""Unit tests: vector math, ONB, reflect/refract (SURVEY.md §4 tier 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.utils import math as vm


def rand_vecs(n, seed=0):
    rs = np.random.RandomState(seed)
    return jnp.asarray(rs.randn(n, 3).astype(np.float32))


def test_normalize_unit_length():
    v = rand_vecs(128)
    n = vm.normalize(v)
    np.testing.assert_allclose(np.asarray(vm.length(n)), 1.0, atol=1e-5)


def test_normalize_zero_safe():
    z = jnp.zeros((4, 3))
    out = vm.normalize(z)
    assert np.all(np.isfinite(np.asarray(out)))


def test_onb_orthonormality():
    n = vm.normalize(rand_vecs(256, seed=1))
    t, b = vm.onb_from_normal(n)
    np.testing.assert_allclose(np.asarray(vm.dot(t, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(b, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(t, b)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(t)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(b)), 1.0, atol=1e-5)


def test_onb_poles():
    # |n.y| >= 0.9999 switches the up vector (reference optixSphere.cu:45)
    n = jnp.asarray([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], jnp.float32)
    t, b = vm.onb_from_normal(n)
    assert np.all(np.isfinite(np.asarray(t)))
    np.testing.assert_allclose(np.asarray(vm.dot(t, n)), 0.0, atol=1e-6)


def test_onb_transform_maps_y_to_normal():
    n = vm.normalize(rand_vecs(64, seed=2))
    t, b = vm.onb_from_normal(n)
    y = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), n.shape)
    out = vm.onb_transform(y, t, n, b)
    np.testing.assert_allclose(np.asarray(out), np.asarray(n), atol=1e-5)


def test_reflect():
    i = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = vm.reflect(i, n)
    np.testing.assert_allclose(
        np.asarray(r), np.asarray([[1.0, 1.0, 0.0]]) / np.sqrt(2), atol=1e-6
    )


def test_faceforward():
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    i = jnp.asarray([[0.0, -1.0, 0.0]])  # incoming from above? i·n<0 -> flip
    out = vm.faceforward(n, i, n)
    np.testing.assert_allclose(np.asarray(out), [[0.0, -1.0, 0.0]])


def test_refract_snell():
    # Air->glass at 45 degrees: the reference passes eta_passed=1.5 from
    # outside; effective ratio 1/1.5.
    theta_i = np.radians(45.0)
    i = jnp.asarray([[np.sin(theta_i), -np.cos(theta_i), 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    r, tir = vm.refract(i, n, jnp.asarray([1.5], jnp.float32))
    assert not bool(tir[0])
    sin_t = float(np.abs(np.asarray(r)[0, 0]))
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, atol=1e-5)


def test_refract_tir():
    # Glass->air beyond the critical angle (eta_passed = 1/1.5).
    theta_i = np.radians(80.0)
    i = jnp.asarray([[np.sin(theta_i), -np.cos(theta_i), 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    r, tir = vm.refract(i, n, jnp.asarray([1.0 / 1.5], jnp.float32))
    assert bool(tir[0])
    np.testing.assert_allclose(np.asarray(r), 0.0)
