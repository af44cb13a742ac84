"""Eigen-solver tests.

Ports the reference's 7 gtest cases (oracle values copied from
reference test/Symmetric3x3EigenvalueSolverTest.cxx:48-90 — the expected
vectors there were produced with numpy.linalg.eig) plus property-based fuzz
against numpy.linalg.eigvalsh, in f64 and f32.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from ife_tpu.ops.eigen import eigenvalues_sym3x3, eigenvalue_features


def solve(m, dtype=jnp.float64):
    return np.asarray(eigenvalues_sym3x3(jnp.asarray(m, dtype=dtype)))


# --- the reference's exact cases ---

def test_identity():
    np.testing.assert_allclose(solve([1, 0, 0, 1, 0, 1]), [1, 1, 1])


def test_diagonal_pos():
    np.testing.assert_allclose(solve([1, 0, 0, 2, 0, 3]), [3, 2, 1])


def test_diagonal_neg():
    np.testing.assert_allclose(solve([-1, 0, 0, -2, 0, -3]), [-3, -2, -1])


def test_diagonal_pos_neg():
    np.testing.assert_allclose(solve([1, 0, 0, -2, 0, 3]), [3, -2, 1])


def test_ones():
    # exact eigenvalues {3, 0, 0}; numerics get within 1e-15 (reference
    # Symmetric3x3EigenvalueSolverTest.cxx:70-78 uses the same epsilon).
    np.testing.assert_allclose(solve([1, 1, 1, 1, 1, 1]), [3, 0, 0], atol=1e-14)


def test_randoms_small():
    got = solve([0.27, 0.92, 0.58, 0.24, 0.75, 0.04])
    np.testing.assert_allclose(
        got, [1.70680634, -0.7205504, -0.43625594], rtol=1e-6
    )


def test_randoms_big():
    got = solve([599, 860, -835, -941, 817, -207])
    np.testing.assert_allclose(
        got, [-2005.21004566, 1183.41690727, 272.79313839], rtol=1e-6
    )


# --- property-based fuzz vs numpy ---

def _pack(M):
    return np.stack(
        [M[..., 0, 0], M[..., 0, 1], M[..., 0, 2], M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]],
        axis=-1,
    )


def _random_sym(n, rng, scale=1.0):
    A = rng.standard_normal((n, 3, 3)) * scale
    return (A + np.swapaxes(A, -1, -2)) / 2


def test_fuzz_matches_numpy_f64():
    rng = np.random.default_rng(42)
    M = _random_sym(5000, rng, scale=100.0)
    got = solve(_pack(M))
    want = np.linalg.eigvalsh(M)  # ascending
    got_sorted = np.sort(got, axis=-1)
    np.testing.assert_allclose(got_sorted, want, rtol=1e-9, atol=1e-7)
    # ordering property: |e3| <= |e2| <= |e1|
    a = np.abs(got)
    assert np.all(a[:, 0] >= a[:, 1] - 1e-9)
    assert np.all(a[:, 1] >= a[:, 2] - 1e-9)


def test_fuzz_f32_accuracy():
    """f32 path (the device production dtype) must stay within 1e-4 relative
    to the f64 oracle on well-scaled Hessian-like inputs."""
    rng = np.random.default_rng(7)
    M = _random_sym(5000, rng, scale=10.0)
    got = solve(_pack(M), dtype=jnp.float32)
    want = np.linalg.eigvalsh(M)
    got_sorted = np.sort(got.astype(np.float64), axis=-1)
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1.0)
    err = np.abs(got_sorted - want) / scale
    assert err.max() < 1e-4, err.max()


def test_degenerate_pairs():
    """Repeated eigenvalues (the acos precision danger zone)."""
    rng = np.random.default_rng(3)
    vals = []
    for lam in ([2.0, 2.0, -1.0], [5.0, 5.0, 5.0], [0.0, 0.0, 1.0], [-3.0, -3.0, -3.0]):
        Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        M = Q @ np.diag(lam) @ Q.T
        M = (M + M.T) / 2
        vals.append(M)
    M = np.stack(vals)
    got = np.sort(solve(_pack(M)), axis=-1)
    want = np.linalg.eigvalsh(M)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_features_functor():
    """EigenvalueFeaturesFunctor semantics: [e1,e2,e3,sum,prod,frob]."""
    m = jnp.asarray([[0.27, 0.92, 0.58, 0.24, 0.75, 0.04]], dtype=jnp.float64)
    f = np.asarray(eigenvalue_features(m))[0]
    ev = f[:3]
    np.testing.assert_allclose(f[3], ev.sum(), rtol=1e-12)
    np.testing.assert_allclose(f[4], ev.prod(), rtol=1e-12)
    np.testing.assert_allclose(f[5], np.sqrt((ev**2).sum()), rtol=1e-12)
    # trace identity: sum of eigenvalues == trace
    np.testing.assert_allclose(f[3], 0.27 + 0.24 + 0.04, rtol=1e-9)


def test_diagonal_tie_ordering_matches_reference():
    """Strict '>' comparisons: ties keep branch order (solver.h:45-83)."""
    # |A11| == |A22| > |A33|, c1 false -> branch !c1 & c3: (a22, a11, a33)
    np.testing.assert_allclose(solve([2, 0, 0, -2, 0, 1]), [-2, 2, 1])
    # all equal magnitude: c1 false, c3 false -> (a33, a22, a11)
    np.testing.assert_allclose(solve([1, 0, 0, -1, 0, 1]), [1, -1, 1])
