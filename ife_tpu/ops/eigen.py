"""Closed-form eigenvalues of symmetric 3x3 matrices, vectorized.

Re-implements the semantics of the reference's per-voxel solver
(reference: include/ife/Numerics/Symmetric3x3EigenvalueSolver.h:33-132) as a
branchless, fully vectorized jnp computation: the ITK per-voxel functor loop
becomes one fused XLA elementwise program over the whole volume, with
`jnp.where` select networks replacing the reference's branches.

Semantics replicated exactly:
  * input packing [A11, A12, A13, A22, A23, A33] (upper triangle, row order);
  * diagonal fast path when the off-diagonal sum-of-squares p1 == 0, with the
    reference's strict-greater comparison tree ordering by |.| descending
    (solver.h:45-83);
  * trigonometric general path (Wikipedia 3x3 algorithm): q = tr/3,
    p = sqrt(((A11-q)^2 + (A22-q)^2 + (A33-q)^2 + 2 p1)/6), B = (A - qI)/p,
    r = det(B)/2, phi = acos(clip(r, -1, 1))/3 (clipping == the reference's
    explicit r<=-1 / r>=1 guards, solver.h:105-116);
  * eig0 = q + 2p cos(phi), eig2 = q + 2p cos(phi + 2pi/3),
    eig1 = 3q - eig0 - eig2;
  * final reorder to |e3| <= |e2| <= |e1| via the reference's two-swap
    network (solver.h:123-129).

And the feature functor (reference:
include/ife/Numerics/EigenvalueFeaturesFunctor.h:20-31): returns
[e1, e2, e3, e1+e2+e3 (Laplacian-of-Gaussian), e1*e2*e3 (Gaussian
curvature), sqrt(e1^2+e2^2+e3^2) (Frobenius norm)].
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _ordered_by_abs_desc_diag(a11, a22, a33):
    """The reference's nested-if ordering of diagonal entries by |.| desc.

    Mirrors Symmetric3x3EigenvalueSolver.h:45-83 exactly, including strict
    '>' comparisons (ties keep the branch-determined order).
    """
    c1 = jnp.abs(a11) > jnp.abs(a22)
    c2 = jnp.abs(a11) > jnp.abs(a33)
    c3 = jnp.abs(a22) > jnp.abs(a33)

    # branch c1 & c2: (a11, c3 ? a22 : a33, c3 ? a33 : a22)
    b1 = (a11, jnp.where(c3, a22, a33), jnp.where(c3, a33, a22))
    # branch c1 & !c2: (a33, a11, a22)
    b2 = (a33, a11, a22)
    # branch !c1 & c3: (a22, c2 ? a11 : a33, c2 ? a33 : a11)
    b3 = (a22, jnp.where(c2, a11, a33), jnp.where(c2, a33, a11))
    # branch !c1 & !c3: (a33, a22, a11)
    b4 = (a33, a22, a11)

    e0 = jnp.where(c1, jnp.where(c2, b1[0], b2[0]), jnp.where(c3, b3[0], b4[0]))
    e1 = jnp.where(c1, jnp.where(c2, b1[1], b2[1]), jnp.where(c3, b3[1], b4[1]))
    e2 = jnp.where(c1, jnp.where(c2, b1[2], b2[2]), jnp.where(c3, b3[2], b4[2]))
    return e0, e1, e2


def eigenvalues_from_channels(a11, a12, a13, a22, a23, a33):
    """Channel-wise core: six same-shape arrays -> (e0, e1, e2) tuple,
    |e2| <= |e1| <= |e0|."""
    dt = a11.dtype
    pi = jnp.asarray(np.pi, dt)

    p1 = a12 * a12 + a13 * a13 + a23 * a23

    # ---- general (non-diagonal) trigonometric path ----
    # One rsqrt replaces the 6 normalization divides + sqrt of the naive
    # form: r = det(B)/2 with B = (A - qI)/p is computed as
    # det(A - qI) * pinv^3 / 2.
    q = (a11 + a22 + a33) * jnp.asarray(1.0 / 3.0, dt)
    d11, d22, d33 = a11 - q, a22 - q, a33 - q
    p2 = d11 * d11 + d22 * d22 + d33 * d33 + 2 * p1
    # p2 > 0 whenever p1 > 0; guard the diagonal lanes (result discarded).
    p2safe = jnp.where(p2 > 0, p2, jnp.asarray(1, dt)) * jnp.asarray(
        1.0 / 6.0, dt
    )
    pinv = jax.lax.rsqrt(p2safe)
    p = p2safe * pinv  # sqrt(p2/6)
    det = (
        d11 * (d22 * d33 - a23 * a23)
        + a12 * (a23 * a13 - a12 * d33)
        + a13 * (a12 * a23 - a13 * d22)
    )
    r = det * (pinv * pinv * pinv) * jnp.asarray(0.5, dt)

    # clip(r) reproduces the reference's r<=-1 -> phi=pi/3, r>=1 -> 0 guards.
    rc = jnp.clip(r, jnp.asarray(-1, dt), jnp.asarray(1, dt))
    phi = jnp.arccos(rc) * jnp.asarray(1.0 / 3.0, dt)
    cphi = jnp.cos(phi)
    cphi2 = jnp.cos(phi + pi * jnp.asarray(2.0 / 3.0, dt))
    g0 = q + 2 * p * cphi
    g2 = q + 2 * p * cphi2
    g1 = 3 * q - g0 - g2  # trace identity

    # Reorder to |e3| <= |e2| <= |e1| with the reference's two swaps.
    s1 = jnp.abs(g0) < jnp.abs(g2)
    t0 = jnp.where(s1, g2, g0)
    t2 = jnp.where(s1, g0, g2)
    s2 = jnp.abs(g1) < jnp.abs(t2)
    t1 = jnp.where(s2, t2, g1)
    t2 = jnp.where(s2, g1, t2)

    # ---- diagonal fast path ----
    diag = p1 == 0
    e0d, e1d, e2d = _ordered_by_abs_desc_diag(a11, a22, a33)

    e0 = jnp.where(diag, e0d, t0)
    e1 = jnp.where(diag, e1d, t1)
    e2 = jnp.where(diag, e2d, t2)
    return e0, e1, e2


def eigenvalues_sym3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric 3x3 matrices, |e3| <= |e2| <= |e1| order.

    Args:
      A: array (..., 6) packed as [A11, A12, A13, A22, A23, A33].

    Returns:
      array (..., 3) of eigenvalues ordered by descending magnitude.
    """
    e0, e1, e2 = eigenvalues_from_channels(*(A[..., i] for i in range(6)))
    return jnp.stack([e0, e1, e2], axis=-1)


def eigenvalue_features(A: jnp.ndarray) -> jnp.ndarray:
    """Six eigenvalue-derived features per matrix.

    [e1, e2, e3, sum(e), prod(e), frobenius] — the reference's
    EigenvalueFeaturesFunctor (EigenvalueFeaturesFunctor.h:20-31).

    Args:
      A: array (..., 6) packed upper triangle.

    Returns:
      array (..., 6).
    """
    ev = eigenvalues_sym3x3(A)
    e0, e1, e2 = ev[..., 0], ev[..., 1], ev[..., 2]
    s = e0 + e1 + e2
    prod = e0 * e1 * e2
    frob = jnp.sqrt(e0 * e0 + e1 * e1 + e2 * e2)
    return jnp.stack([e0, e1, e2, s, prod, frob], axis=-1)
