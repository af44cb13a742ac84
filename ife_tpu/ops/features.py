"""The flagship 8-channel emphysema feature pass.

Reference: include/ife/Filters/ImageToEmphysemaFeaturesFilter.{h,hxx} —
an ITK mini-DAG of ~20 filters with full-volume intermediates. Here it is a
single jitted function; XLA fuses the mask/select/eigen elementwise work
into the stencil passes, and there are exactly three materialized
full-volume tensors (smoothed, hessian, features).

Channel order (authoritative names at reference
tools/DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures.cxx:270 and
tools/ExtractFeatures.cxx:126-130):
  0 GaussianBlur          masked normalized-convolution smoothing
  1 GradientMagnitude     central-difference |grad| of (0)
  2 Eigenvalue1           Hessian eigenvalues of (0), |e3|<=|e2|<=|e1|
  3 Eigenvalue2
  4 Eigenvalue3
  5 LaplacianOfGaussian   e1+e2+e3
  6 GaussianCurvature     e1*e2*e3
  7 FrobeniusNorm         sqrt(e1^2+e2^2+e3^2)

All channels are masked to 0 outside the (binary) mask, replicating the 8
MaskImageFilters at ImageToEmphysemaFeaturesFilter.hxx:44-54. The
normalized convolution divides without epsilon; resulting nan/inf lives
only outside the mask and is zeroed here — replicating the reference's
observable (masked) behavior, per SURVEY.md §7 hard-part 5.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from ife_tpu.ops.eigen import eigenvalue_features
from ife_tpu.ops.stencil import (
    centered_normalized_convolution,
    gradient_magnitude,
    hessian,
    normalized_gaussian_convolution,
)

FEATURE_NAMES = (
    "GaussianBlur",
    "GradientMagnitude",
    "Eigenvalue1",
    "Eigenvalue2",
    "Eigenvalue3",
    "LaplacianOfGaussian",
    "GaussianCurvature",
    "FrobeniusNorm",
)
NUM_FEATURES = 8  # reference ImageToEmphysemaFeaturesFilter.h:62


def clamp_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """Clamp a labeled mask to binary {0,1} (labels 2,3,... -> 1).

    Mirrors the itk::ClampImageFilter(0,1) applied before every feature
    pass (reference tools/ExtractFeatures.cxx:98-104, MakeBag.cxx:239-244).
    """
    return jnp.clip(mask, 0, 1)


def features8(
    image: jnp.ndarray,
    mask: jnp.ndarray,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> jnp.ndarray:
    """8-channel feature volume at one scale. Returns (X, Y, Z, 8).

    `mask` may be any integer/float labels; it is clamped to {0,1} and used
    both as the normalized-convolution certainty and the output mask, as in
    the reference DAG (ImageToEmphysemaFeaturesFilter.hxx:14-55).
    """
    m = clamp_mask(mask)
    mf = m.astype(image.dtype)

    # derivatives of the offset-free field t (smoothed = t + k): see
    # centered_normalized_convolution for why
    t, k = centered_normalized_convolution(image, mf, sigma, spacing,
                                           truncate)
    gm = gradient_magnitude(t, spacing)
    H = hessian(t, spacing)
    eig = eigenvalue_features(H)  # (..., 6)

    feats = jnp.concatenate(
        [(t + k)[..., None], gm[..., None], eig], axis=-1
    )
    inside = (m != 0)[..., None]
    return jnp.where(inside, feats, jnp.zeros((), image.dtype))


@functools.partial(jax.jit, static_argnames=("sigma", "spacing", "truncate"))
def features8_channels_jit(image, mask, *, sigma, spacing=(1.0, 1.0, 1.0),
                           truncate=4.5):
    """features8 as one jitted program returning a TUPLE of 8 (X, Y, Z)
    channels. The channel slices sit inside the jit, so XLA emits eight
    outputs and never materializes the channel-last (X, Y, Z, 8)
    volume."""
    f = features8(image, mask, sigma, spacing, truncate)
    return tuple(f[..., k] for k in range(NUM_FEATURES))


def normalized_convolution_auto(image, certainty, sigma,
                                spacing=(1.0, 1.0, 1.0), truncate=4.5):
    """Masked (normalized) Gaussian convolution as the CLI calls it: the
    separable XLA expression of ops.stencil.normalized_gaussian_convolution.

    The certainty is used RAW (no clamp): the reference
    NormalizedGaussianConvolutionImageFilter.hxx:40-63 consumes the
    certainty image as given, and the CLI tool
    (tools/MaskedNormalizedConvolution.cxx:141-203) passes it straight
    from disk — G*(c*f)/G*c is invariant to uniform scaling of c but NOT
    to per-voxel clipping, so continuous or >1-valued certainties must
    not be clipped here. Only the features8 paths clamp, mirroring the
    reference's own ClampImageFilter(0,1) there."""
    c = jnp.asarray(certainty).astype(image.dtype)
    return normalized_gaussian_convolution(
        image, c, float(sigma), tuple(spacing), truncate)


def features8_auto_channels(image, mask, sigma, spacing=(1.0, 1.0, 1.0),
                            truncate=4.5):
    """The 8 feature channels at one scale as a tuple of (X, Y, Z) arrays:
    the entry point the CLI, the bag builders and the benchmark call.
    Preferred when consumers read channels independently."""
    return features8_channels_jit(
        image, mask, sigma=float(sigma), spacing=tuple(spacing),
        truncate=truncate,
    )


def features8_auto(image, mask, sigma, spacing=(1.0, 1.0, 1.0), truncate=4.5):
    """features8_auto_channels stacked channel-last, (X, Y, Z, 8). Both
    forms come from the same compiled program, so they agree bit for bit
    (the host and device bag paths rely on it)."""
    return jnp.stack(
        features8_auto_channels(image, mask, sigma, spacing, truncate),
        axis=-1)


def multiscale_features(
    image: jnp.ndarray,
    mask: jnp.ndarray,
    sigmas: Sequence[float],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> jnp.ndarray:
    """Features at several scales, stacked: (X, Y, Z, n_scales, 8).

    The reference loops scales at the tool level re-running the whole DAG
    (tools/MakeBag.cxx:405-412); here scales stay on-device, each through
    features8_auto.
    """
    per_scale = [
        features8_auto(image, mask, float(s), spacing, truncate)
        for s in sigmas
    ]
    return jnp.stack(per_scale, axis=-2)


def hessian_eig_features(
    image: jnp.ndarray, spacing: Sequence[float] = (1.0, 1.0, 1.0)
) -> jnp.ndarray:
    """Unsmoothed Hessian -> 6 eigen features. The benchmark hot path
    (BASELINE.json metric: 'Hessian+eig voxels/sec/chip')."""
    return eigenvalue_features(hessian(image, spacing))
