"""Golden test: the flagship features8 op vs the NumPy/SciPy re-derivation.

This is the JAX rebirth of the reference's §3.1 call stack
(ExtractFeatures -> ImageToEmphysemaFeaturesFilter); target tolerance is
the BASELINE.json north star (1e-5 max abs, here much tighter in f64).
"""
import numpy as np
import jax.numpy as jnp

from ife_tpu.core.volume import synthetic_ct, sphere_mask
from ife_tpu.ops.features import features8, multiscale_features, FEATURE_NAMES
from tests import numpy_ref as ref


def _data(shape=(32, 32, 32)):
    img = synthetic_ct(shape, seed=11, dtype=jnp.float64).numpy()
    mask = sphere_mask(shape, 0.38).numpy().astype(np.uint16)
    # make it a labeled mask (1=right lung, 2=left lung) to exercise clamping
    mask[: shape[0] // 2] *= 2
    return img, mask


SPACING = (0.78, 0.78, 1.0)


def test_features8_matches_numpy_f64():
    img, mask = _data()
    for sigma in (0.6, 1.2):
        got = np.asarray(
            features8(jnp.asarray(img), jnp.asarray(mask), sigma, SPACING)
        )
        want = ref.features8_np(img, mask, sigma, SPACING)
        err = np.abs(got - want)
        assert err.max() < 1e-6, (sigma, err.max())
        # everything outside the mask is exactly 0
        outside = np.clip(mask, 0, 1) == 0
        assert np.all(got[outside] == 0.0)
        assert np.all(np.isfinite(got))


def test_features8_f32_within_north_star():
    """f32 (device production dtype) vs f64 oracle, per-channel budget.

    The 1e-5 north star (BASELINE.md) holds for channels 0-3 and 7. It is
    UNREACHABLE for Eigenvalue3 / LoG / GaussianCurvature — and the gap
    is input conditioning, not implementation: running the eigen solve in
    f64 on the f32 Hessian reproduces the error bit-for-near-bit (e3
    1.70e-5 vs 1.69e-5, measured round 3), i.e. 100% of the excess is the
    f32 smoothing roundoff (~2.4 ulps of the value scale, already
    optimal) amplified by the second-difference conditioning 4/h^2 —
    abs ~1.1e-3 on the Hessian channels, large relative to the SMALLEST
    eigenvalue's channel scale. The reference's own float32 pixel type
    shares this bound exactly. Full budget table: docs/design.md.

    Bounds below are the measured values with ~40% headroom so any
    implementation regression still fails fast.
    """
    img, mask = _data()
    sigma = 1.0
    got = np.asarray(
        features8(
            jnp.asarray(img, jnp.float32), jnp.asarray(mask), sigma, SPACING
        )
    ).astype(np.float64)
    want = ref.features8_np(img, mask, sigma, SPACING)
    budget = {
        "GaussianBlur": 1e-6,        # measured 2.8e-7
        "GradientMagnitude": 2e-6,   # measured 7.6e-7
        "Eigenvalue1": 1e-5,         # measured 7.6e-6
        "Eigenvalue2": 1e-5,         # measured 8.3e-6
        "Eigenvalue3": 2.4e-5,       # measured 1.70e-5 (conditioning-bound)
        "LaplacianOfGaussian": 1.5e-5,   # measured 1.09e-5 (ditto)
        "GaussianCurvature": 1.5e-5,     # measured 1.10e-5 (ditto)
        "FrobeniusNorm": 1.3e-5,     # measured 9.2e-6
    }
    for c in range(8):
        scale = max(np.abs(want[..., c]).max(), 1.0)
        err = np.abs(got[..., c] - want[..., c]).max() / scale
        assert err < budget[FEATURE_NAMES[c]], (FEATURE_NAMES[c], err)


def test_normalized_convolution_auto_uses_raw_certainty():
    """The CLI normalized-convolution path must NOT clip the certainty:
    the reference filter consumes it raw
    (NormalizedGaussianConvolutionImageFilter.hxx:40-63) and the ratio
    G*(c*f)/G*c is invariant to uniform scaling of c but not to per-voxel
    clipping. Continuous and >1-valued certainties must match the
    unclamped formula exactly (round-3 advisor finding)."""
    from ife_tpu.ops.features import normalized_convolution_auto
    from ife_tpu.ops.stencil import gaussian_smooth

    rng = np.random.default_rng(3)
    shape = (16, 16, 16)
    img = jnp.asarray(rng.standard_normal(shape) * 100.0)
    # continuous certainty with values in (0, 2.5] — clipping would alter it
    cert = jnp.asarray(rng.uniform(0.05, 2.5, shape))
    sigma = 1.1
    got = np.asarray(
        normalized_convolution_auto(img, cert, sigma, SPACING))
    num = np.asarray(gaussian_smooth(img * cert, sigma, SPACING))
    den = np.asarray(gaussian_smooth(cert, sigma, SPACING))
    want = num / den
    assert np.abs(got - want).max() < 1e-12
    # and clipping WOULD have changed the answer (the test has teeth)
    numc = np.asarray(gaussian_smooth(img * jnp.clip(cert, 0, 1), sigma,
                                      SPACING))
    denc = np.asarray(gaussian_smooth(jnp.clip(cert, 0, 1), sigma, SPACING))
    assert np.abs(numc / denc - want).max() > 1e-3


def test_multiscale_stacking():
    img, mask = _data((20, 20, 20))
    sigmas = (0.5, 1.0, 2.0)
    ms = np.asarray(
        multiscale_features(jnp.asarray(img), jnp.asarray(mask), sigmas, SPACING)
    )
    assert ms.shape == (20, 20, 20, 3, 8)
    # multiscale routes through the per-scale dispatch (features8_auto),
    # so the slice-equality oracle must take the same path (eager-vs-jit
    # op fusion differs at the ulp level)
    from ife_tpu.ops.features import features8_auto

    single = np.asarray(
        features8_auto(jnp.asarray(img), jnp.asarray(mask), 1.0, SPACING))
    np.testing.assert_array_equal(ms[..., 1, :], single)
    loose = np.asarray(
        features8(jnp.asarray(img), jnp.asarray(mask), 1.0, SPACING))
    # eager vs jit differ by fusion-level rounding only (~2e-10 abs at
    # value scale ~1e3)
    np.testing.assert_allclose(ms[..., 1, :], loose, atol=1e-8)
