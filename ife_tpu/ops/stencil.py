"""Finite-difference and separable-Gaussian stencils with ZeroFluxNeumann
boundaries, as whole-volume XLA programs.

The reference builds these from ITK filter objects:
  * itk::DerivativeImageFilter (central differences, ZeroFluxNeumann
    boundary, spacing-scaled) — used 8x by the Hessian
    (reference: include/ife/Filters/Hessian3DImageFilter.hxx:19-59; the
    central-difference + ZeroFluxNeumann convention is documented at
    reference tools/FiniteDifference_HessianFeatures.cxx:4-7);
  * itk::GradientMagnitudeImageFilter (3-axis central difference,
    spacing-scaled, ZeroFluxNeumann);
  * itk::SmoothingRecursiveGaussianImageFilter (Deriche IIR approximation,
    sigma in physical units).

Design notes:
  * Each stencil is a pad(edge)+shift+fma expression — XLA fuses the whole
    thing into one elementwise pass; there are no per-filter full-volume
    intermediates like ITK's demand-driven DAG.
  * The Gaussian is a truncated FIR sampled-Gaussian (radius ~ 4.5 sigma,
    tail mass < 1e-5) instead of ITK's IIR recursion: an IIR scan is
    sequential along an axis, while FIR taps vectorize across every line
    of the volume, and the truncation error is comparable to the Deriche
    approximation error of the reference. This is the documented
    divergence called out in SURVEY.md §7.
  * FIR convolution is applied axis-by-axis as an edge pad plus a VALID
    1-D `conv_general_dilated` at Precision.HIGHEST.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp


Axis = int  # 0=x, 1=y, 2=z (ITK direction order)

# Precision of the smoothing convolution. An f32 conv or dot on a GPU may
# run in TF32 (~1e-3 relative) unless asked for HIGHEST; the f32 features
# are held to 1e-4 of the f64 reference, so TF32 is never acceptable here.
CONV_PRECISION = jax.lax.Precision.HIGHEST


def _edge_pad(x: jnp.ndarray, axis: Axis, lo: int, hi: int) -> jnp.ndarray:
    """ZeroFluxNeumann = replicate the boundary voxel."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (lo, hi)
    return jnp.pad(x, pad, mode="edge")


def _shift(x: jnp.ndarray, axis: Axis, offset: int, size: int) -> jnp.ndarray:
    """Slice a window of `size` at `offset` along axis from a padded array."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(offset, offset + size)
    return x[tuple(idx)]


def derivative(
    x: jnp.ndarray, axis: Axis, order: int, spacing: float = 1.0
) -> jnp.ndarray:
    """Central-difference derivative along one axis.

    order=1: (f[i+1] - f[i-1]) / (2h);  order=2: (f[i+1] - 2 f[i] + f[i-1]) / h^2.
    ZeroFluxNeumann boundary (edge replicate). Mirrors
    itk::DerivativeImageFilter as wired by the reference Hessian
    (Hessian3DImageFilter.hxx:23-51).
    """
    n = x.shape[axis]
    xp = _edge_pad(x, axis, 1, 1)
    fm = _shift(xp, axis, 0, n)
    f0 = _shift(xp, axis, 1, n)
    fp = _shift(xp, axis, 2, n)
    # multiply by the f64-folded reciprocal (the same constant the sharded
    # path uses, so the two agree to the ulp)
    h = float(spacing)
    if order == 1:
        return (fp - fm) * jnp.asarray(1.0 / (2.0 * h), x.dtype)
    elif order == 2:
        return (fp - 2 * f0 + fm) * jnp.asarray(1.0 / (h * h), x.dtype)
    raise ValueError(f"order must be 1 or 2, got {order}")


def gradient_magnitude(
    x: jnp.ndarray, spacing: Sequence[float] = (1.0, 1.0, 1.0)
) -> jnp.ndarray:
    """sqrt(sum_d (df/dx_d)^2) with central differences.

    Mirrors itk::GradientMagnitudeImageFilter as used at
    reference ImageToEmphysemaFeaturesFilter.hxx:27-28.
    """
    acc = None
    for d in range(3):
        g = derivative(x, d, 1, spacing[d])
        acc = g * g if acc is None else acc + g * g
    return jnp.sqrt(acc)


def hessian(
    x: jnp.ndarray, spacing: Sequence[float] = (1.0, 1.0, 1.0)
) -> jnp.ndarray:
    """6-channel Hessian, channel order [Dxx, Dxy, Dxz, Dyy, Dyz, Dzz].

    Pure second derivatives are single order-2 stencils; cross derivatives
    are CASCADED order-1 stencils (Dx then Dy, Dx then Dz, Dy then Dz), each
    pass applying its own ZeroFluxNeumann boundary — this matches the
    reference wiring exactly (Hessian3DImageFilter.hxx:31-59), which differs
    from a single 2D cross stencil in the two boundary layers.

    Returns array (..., 6) stacked on a new trailing axis.
    """
    dxx = derivative(x, 0, 2, spacing[0])
    dyy = derivative(x, 1, 2, spacing[1])
    dzz = derivative(x, 2, 2, spacing[2])
    dx = derivative(x, 0, 1, spacing[0])
    dy = derivative(x, 1, 1, spacing[1])
    dxy = derivative(dx, 1, 1, spacing[1])
    dxz = derivative(dx, 2, 1, spacing[2])
    dyz = derivative(dy, 2, 1, spacing[2])
    return jnp.stack([dxx, dxy, dxz, dyy, dyz, dzz], axis=-1)


# ---------------------------------------------------------------------------
# Gaussian smoothing
# ---------------------------------------------------------------------------

def gaussian_radius(sigma_vox: float, truncate: float = 4.5) -> int:
    """FIR truncation radius in voxels for a given sigma (in voxels)."""
    return max(1, int(math.ceil(truncate * sigma_vox)))


@functools.lru_cache(maxsize=256)
def _gaussian_taps(sigma_vox: float, radius: int) -> np.ndarray:
    """Normalized sampled-Gaussian taps, length 2*radius+1 (float64)."""
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * sigma_vox * sigma_vox))
    return g / g.sum()


def _conv1d_valid(x_last: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """VALID 1D convolution along the last axis: (..., n+K-1) -> (..., n).

    taps are symmetric, so convolution == correlation (no flip needed).
    """
    lead = x_last.shape[:-1]
    lhs = x_last.reshape((-1, 1, x_last.shape[-1]))
    rhs = taps.reshape((1, 1, taps.shape[0]))
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=CONV_PRECISION,
        preferred_element_type=x_last.dtype,
    )
    return out.reshape(lead + (out.shape[-1],))


def convolve_valid_axis(
    x_ext: jnp.ndarray, axis: Axis, sigma_vox: float, radius: int
) -> jnp.ndarray:
    """VALID Gaussian along `axis` of an already-extended array
    ((..., n+2*radius, ...) -> (..., n, ...)): a 1-D conv over the moved
    axis. Used by gaussian_smooth_axis and the sharded halo path."""
    taps = jnp.asarray(_gaussian_taps(sigma_vox, radius), dtype=x_ext.dtype)
    y = _conv1d_valid(jnp.moveaxis(x_ext, axis, -1), taps)
    return jnp.moveaxis(y, -1, axis)


def gaussian_smooth_axis(
    x: jnp.ndarray, axis: Axis, sigma: float, spacing: float = 1.0,
    truncate: float = 4.5,
) -> jnp.ndarray:
    """1D Gaussian along `axis`, sigma in PHYSICAL units (like ITK),
    ZeroFluxNeumann boundary: edge-pad + VALID convolution, O(K) work per
    voxel (K = 2*radius+1 taps)."""
    if sigma <= 0:
        return x
    sigma_vox = float(sigma) / float(spacing)
    radius = gaussian_radius(sigma_vox, truncate)
    return convolve_valid_axis(
        _edge_pad(x, axis, radius, radius), axis, sigma_vox, radius)


def gaussian_smooth(
    x: jnp.ndarray,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> jnp.ndarray:
    """Separable isotropic (in physical units) Gaussian smoothing.

    Semantics target: itk::SmoothingRecursiveGaussianImageFilter with
    SetSigma(sigma) (reference NormalizedGaussianConvolutionImageFilter
    .hxx:51-55). We use a truncated FIR sampled Gaussian — documented
    divergence from the Deriche IIR approximation; both approximate the
    continuous Gaussian, parity is established against the exact kernel.
    """
    for d in range(3):
        x = gaussian_smooth_axis(x, d, sigma, spacing[d], truncate)
    return x


def smoothing_offset(image: jnp.ndarray) -> jnp.ndarray:
    """The image mean rounded to an integer, in the image dtype (0 if the
    mean is not finite). Rounding makes the offset independent of the
    summation order, so a sharded run (a psum of per-shard sums) and a
    single-device run smooth about the same value."""
    k = jnp.round(jnp.mean(image))
    return jnp.where(jnp.isfinite(k), k, 0).astype(image.dtype)


def centered_normalized_convolution(
    image: jnp.ndarray,
    certainty: jnp.ndarray,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
):
    """(t, k) with t + k = G_sigma*(c*T) / G_sigma*c: the image is smoothed
    about an offset k = smoothing_offset(image), its rounded mean.

    Normalized convolution is exact under a constant offset —
    G*(c(T-k))/G*c = G*(cT)/G*c - k for any certainty — so the offset
    changes nothing mathematically. Numerically it keeps the f32 sums
    small: CT values sit hundreds of HU away from zero, and the rounding
    of the smoothed field, amplified by 4/h^2 in the second differences,
    was the whole f32 error of the Hessian channels (docs/design.md,
    precision policy). Derivatives are taken of t, which needs no k.
    """
    c = certainty.astype(image.dtype)
    k = smoothing_offset(image)
    num = gaussian_smooth((image - k) * c, sigma, spacing, truncate)
    den = gaussian_smooth(c, sigma, spacing, truncate)
    return num / den, k


def normalized_gaussian_convolution(
    image: jnp.ndarray,
    certainty: jnp.ndarray,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> jnp.ndarray:
    """Knutsson–Westin normalized convolution, 0th order:
    out = G_sigma*(c*T) / G_sigma*c.

    Mirrors reference NormalizedGaussianConvolutionImageFilter.hxx:40-63:
    multiply -> two Gaussians -> divide, with NO epsilon in the divide.
    Far outside the certainty support this is IEEE 0/0 = nan, exactly like
    the reference; callers mask the result (SURVEY.md §7 hard-part 5).
    Computed about the image mean (centered_normalized_convolution).
    """
    t, k = centered_normalized_convolution(image, certainty, sigma, spacing,
                                           truncate)
    return t + k
