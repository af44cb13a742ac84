"""Deriche recursive (IIR) Gaussian — host-side reference implementation.

The reference smooths with itk::SmoothingRecursiveGaussianImageFilter
(reference include/ife/Filters/NormalizedGaussianConvolutionImageFilter.h:50,72),
which is itk::RecursiveGaussianImageFilter per axis: R. Deriche's 4th-order
IIR approximation of the Gaussian ("Recursively implementing the gaussian
and its derivatives", INRIA RR-1893, 1993) — the classic coefficients
(a0 1.680, a1 3.735, c0 -0.6803, c1 -0.2598, omega0 0.6318, omega1 1.997,
b0 1.783, b1 1.723) are the ones in ITK's source.

The device compute path deliberately uses a truncated FIR sampled
Gaussian instead (ops/stencil.py: an IIR scan is sequential along an
axis, while FIR taps vectorize across every line of the volume). BOTH are approximations of the continuous Gaussian; this
module exists to put a NUMBER on the divergence (SURVEY.md §7 hard-part 2):
tests/test_stencil.py bounds the FIR-vs-IIR delta and docs/design.md
records the measured table. It is host-side NumPy, correctness-only —
never on the hot path.

Boundary handling: the input is edge-replicate padded by max(10*sigma, 16)
voxels before the causal/anticausal recursions and cropped after — the
ideal constant-extension (ZeroFluxNeumann) response, free of recursion
initialization artifacts.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

# Deriche 1993 4th-order coefficients for the 0th derivative (smoothing),
# as used by itk::RecursiveGaussianImageFilter.
_A0, _A1 = 1.680, 3.735
_C0, _C1 = -0.6803, -0.2598
_W0, _B0 = 0.6318, 1.783
_W1, _B1 = 1.997, 1.723


def _deriche_coeffs(sigma_vox: float):
    """(numerator+ (n0..n3), denominator (d1..d4)) of the causal quarter
    of the Deriche recursion, DC-normalized so the full (causal +
    anticausal) filter has unit gain."""
    s = float(sigma_vox)
    a0c, a1c = math.exp(-_B0 / s), math.exp(-_B1 / s)
    cw0, sw0 = math.cos(_W0 / s), math.sin(_W0 / s)
    cw1, sw1 = math.cos(_W1 / s), math.sin(_W1 / s)

    d1 = -2 * a1c * cw1 - 2 * a0c * cw0
    d2 = 4 * a0c * a1c * cw0 * cw1 + a0c * a0c + a1c * a1c
    d3 = -2 * a0c * a0c * a1c * cw1 - 2 * a1c * a1c * a0c * cw0
    d4 = a0c * a0c * a1c * a1c

    n0 = _A0 + _C0
    n1 = (a1c * (_C1 * sw1 - (_C0 + 2 * _A0) * cw1)
          + a0c * (_A1 * sw0 - (2 * _C0 + _A0) * cw0))
    n2 = (2 * a0c * a1c * ((_A0 + _C0) * cw1 * cw0
                           - _A1 * cw1 * sw0 - _C1 * cw0 * sw1)
          + _C0 * a0c * a0c + _A0 * a1c * a1c)
    n3 = (a0c * a0c * a1c * (_C1 * sw1 - _C0 * cw1)
          + a1c * a1c * a0c * (_A1 * sw0 - _A0 * cw0))

    num = np.array([n0, n1, n2, n3], dtype=np.float64)
    den = np.array([1.0, d1, d2, d3, d4], dtype=np.float64)

    # DC gain of causal + anticausal (anticausal numerator is derived from
    # the causal one below; its DC gain is sum(num-) / sum(den) with
    # num-_k = num_k - den_k * n0 for k=1..3 and num-_4 = -d4 * n0):
    sum_num = num.sum()
    sum_den = den.sum()
    sum_num_anti = (num[1:].sum() - (den[1:4].sum()) * n0) - d4 * n0
    gain = (sum_num + sum_num_anti) / sum_den
    num /= gain
    return num, den


def _smooth_last_axis(x: np.ndarray, sigma_vox: float) -> np.ndarray:
    from scipy.signal import lfilter

    num, den = _deriche_coeffs(sigma_vox)
    pad = max(int(math.ceil(10 * sigma_vox)), 16)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")

    causal = lfilter(num, den, xp, axis=-1)
    # anticausal: numerator shifted one sample (acts on x[n+1..n+4]),
    # coefficients n-_k = n_k - d_k n_0 (k=1..3), n-_4 = -d4 n_0; run the
    # recursion on the reversed signal.
    n0 = num[0]
    num_anti = np.array([
        0.0,
        num[1] - den[1] * n0,
        num[2] - den[2] * n0,
        num[3] - den[3] * n0,
        -den[4] * n0,
    ], dtype=np.float64)
    anti = lfilter(num_anti, den, xp[..., ::-1], axis=-1)[..., ::-1]
    out = causal + anti
    return out[..., pad:-pad]


def deriche_gaussian_smooth(
    x: np.ndarray,
    sigma: float,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """Separable Deriche IIR Gaussian, sigma in PHYSICAL units (like ITK).

    Host-side float64 reference of the itk::SmoothingRecursiveGaussian
    semantics the reference pipeline uses; see module docstring.
    """
    out = np.asarray(x, dtype=np.float64)
    for axis in range(out.ndim):
        sv = float(sigma) / float(spacing[axis])
        out = np.moveaxis(
            _smooth_last_axis(np.moveaxis(out, axis, -1), sv), -1, axis
        )
    return out
