"""Analytic unit tests for the cubic-spline kernel (SURVEY.md §4a):
normalisation, support, continuity, and gradient-vs-finite-difference."""

import numpy as np
import jax.numpy as jnp
import pytest

from tisph.ops.kernels import cubic_kernel, cubic_kernel_grad


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_normalizes_to_one(dim):
    """Integral of W over R^dim must be 1 for any h."""
    h = 0.13
    n = 161
    xs = np.linspace(-h, h, n)
    grids = np.meshgrid(*([xs] * dim), indexing="ij")
    r = np.sqrt(sum(g**2 for g in grids))
    w = np.asarray(cubic_kernel(jnp.asarray(r.ravel(), jnp.float32), h, dim))
    dv = (xs[1] - xs[0]) ** dim
    assert abs(w.sum() * dv - 1.0) < 2e-2


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_compact_support(dim):
    h = 0.04
    r = jnp.asarray([h, 1.5 * h, 100.0])
    assert np.allclose(np.asarray(cubic_kernel(r, h, dim)), 0.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_continuity_at_half(dim):
    h = 1.0
    eps = 1e-6
    lo = float(cubic_kernel(jnp.asarray(0.5 - eps), h, dim))
    hi = float(cubic_kernel(jnp.asarray(0.5 + eps), h, dim))
    assert abs(lo - hi) < 1e-4


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_positive_and_decreasing(dim):
    h = 0.04
    r = jnp.linspace(0.0, h * 0.999, 100)
    w = np.asarray(cubic_kernel(r, h, dim))
    assert (w > 0).all()
    assert (np.diff(w) <= 1e-9).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_gradient_matches_finite_difference(dim):
    h = 0.04
    rng = np.random.default_rng(0)
    pts = rng.uniform(-h, h, size=(64, dim)).astype(np.float32)
    pts = pts[np.linalg.norm(pts, axis=1) > 0.05 * h]
    g = np.asarray(cubic_kernel_grad(jnp.asarray(pts), h, dim))
    eps = 1e-4 * h
    for axis in range(dim):
        e = np.zeros(dim, np.float32)
        e[axis] = eps
        wp = np.asarray(cubic_kernel(jnp.linalg.norm(jnp.asarray(pts + e), axis=1), h, dim))
        wm = np.asarray(cubic_kernel(jnp.linalg.norm(jnp.asarray(pts - e), axis=1), h, dim))
        fd = (wp - wm) / (2 * eps)
        scale = np.abs(g[:, axis]).max() + 1e-3
        np.testing.assert_allclose(g[:, axis] / scale, fd / scale, atol=5e-3)


@pytest.mark.parametrize("dim", [2, 3])
def test_gradient_antisymmetric(dim):
    h = 0.04
    rng = np.random.default_rng(1)
    r = rng.uniform(-h / 2, h / 2, size=(32, dim)).astype(np.float32)
    g_pos = np.asarray(cubic_kernel_grad(jnp.asarray(r), h, dim))
    g_neg = np.asarray(cubic_kernel_grad(jnp.asarray(-r), h, dim))
    np.testing.assert_allclose(g_pos, -g_neg, atol=1e-6)


def test_gradient_zero_at_origin_and_outside():
    h = 0.04
    r = jnp.asarray([[0.0, 0.0, 0.0], [h, h, h], [2 * h, 0.0, 0.0]])
    g = np.asarray(cubic_kernel_grad(r, h, 3))
    assert np.allclose(g, 0.0)


def test_eos():
    from tisph.ops.eos import tait_pressure

    rho = jnp.asarray([900.0, 1000.0, 1100.0])
    rho_c, p = tait_pressure(rho, 1000.0, 50.0, 7.0)
    rho_c, p = np.asarray(rho_c), np.asarray(p)
    assert rho_c[0] == 1000.0  # clamped up
    assert p[0] == 0.0
    assert abs(p[1]) < 1e-6
    expected = 50.0 * (1.1**7 - 1.0)
    np.testing.assert_allclose(p[2], expected, rtol=1e-5)
