"""The plain XLA feature path against the independent f64 NumPy reference,
at the shapes that break tiled or padded implementations: prime extents,
smoothing radius larger than the volume, Y/Z not multiples of 8,
anisotropic thick slices, tiny volumes — plus the dispatched entry
points (features8_auto / _channels, normalized_convolution_auto,
hessian_eig_features), multi-scale equal to per-scale, f32 within the
on-device budget, and sharded halo-extended faces against one device.

Eigen channels 2-4 are compared as value-sorted triples: the
|e|-descending ORDER legitimately swaps at near-ties under any ulp-level
perturbation (in the reference C++ too).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ife_tpu.core.volume import sphere_mask, synthetic_ct
from ife_tpu.ops.features import (
    features8, features8_auto, features8_auto_channels,
    hessian_eig_features, multiscale_features, normalized_convolution_auto,
)
from ife_tpu.parallel import (
    make_mesh, shard_volume, sharded_features8, sharded_hessian_eig,
)
from gpu_verify import (
    BUDGET, check_within, eigen_feature_errors, feature_errors, gate_scan,
)
from tests import numpy_ref as ref

SPACING = (0.7, 0.9, 1.2)

# (shape, sigma, spacing): the edge cases that tiled or padded kernels
# get wrong, held by the plain path
CASES = {
    "prime_extents": ((13, 11, 17), 0.9, SPACING),
    "radius_larger_than_volume": ((16, 16, 16), 2.5, SPACING),
    "unaligned_y_z": ((14, 13, 19), 1.1, SPACING),
    "anisotropic_2_5mm": ((20, 18, 12), 1.2, (0.78, 0.78, 2.5)),
    "anisotropic_5mm": ((20, 18, 10), 2.4, (0.7, 0.7, 5.0)),
    "tiny_volume": ((4, 4, 8), 0.6, SPACING),
}


def _data(shape, seed=7):
    img = np.asarray(synthetic_ct(shape, seed=seed, dtype=jnp.float64).data)
    mask = np.asarray(sphere_mask(shape, 0.45).data).astype(np.uint16)
    mask[: max(1, shape[0] // 3)] *= 2  # labels 1/2 exercise the clamp
    return img, mask


def _assert_features_close(got, want, tol):
    errs = feature_errors(got, want)
    check_within("features", errs, tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_features8_auto_matches_reference(case):
    shape, sigma, spacing = CASES[case]
    img, mask = _data(shape)
    got = np.asarray(features8_auto(jnp.asarray(img), jnp.asarray(mask),
                                    sigma, spacing))
    want = ref.features8_np(img, mask, sigma, spacing)
    _assert_features_close(got, want, 1e-9)
    outside = np.clip(mask, 0, 1) == 0
    assert np.all(got[outside] == 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_normalized_convolution_auto_matches_reference(case):
    shape, sigma, spacing = CASES[case]
    img, mask = _data(shape)
    cert = np.clip(mask, 0, 1).astype(np.float64)
    got = np.asarray(normalized_convolution_auto(
        jnp.asarray(img), jnp.asarray(cert), sigma, spacing))
    want = ref.normalized_conv_np(img, cert, sigma, spacing)
    inside = cert != 0
    np.testing.assert_allclose(got[inside], want[inside], rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape,spacing", [
    ((16, 16, 16), SPACING),
    ((13, 11, 17), SPACING),
    ((12, 10, 9), (0.78, 0.78, 2.5)),
    ((4, 4, 8), (1.0, 1.0, 1.0)),
])
def test_hessian_eig_features_matches_reference(shape, spacing):
    img = np.asarray(synthetic_ct(shape, seed=2, dtype=jnp.float64).data)
    got = np.asarray(hessian_eig_features(jnp.asarray(img), spacing))
    want = ref.eig_features_np(ref.hessian_np(img, spacing))
    check_within("hessian_eig", eigen_feature_errors(got, want), 1e-9)


def test_channels_form_is_bitwise_the_stacked_form():
    img, mask = _data((14, 13, 19))
    a = np.asarray(features8_auto(jnp.asarray(img), jnp.asarray(mask), 1.1,
                                  SPACING))
    chans = features8_auto_channels(jnp.asarray(img), jnp.asarray(mask),
                                    1.1, SPACING)
    assert len(chans) == 8
    np.testing.assert_array_equal(np.stack([np.asarray(c) for c in chans],
                                           -1), a)


@pytest.fixture(scope="module")
def multiscale():
    img, mask = _data((18, 17, 15))
    sigmas = (0.6, 1.2, 2.4, 4.8)
    ms = np.asarray(multiscale_features(jnp.asarray(img), jnp.asarray(mask),
                                        sigmas, SPACING))
    return img, mask, sigmas, ms


@pytest.mark.parametrize("i", range(4))
def test_multiscale_equals_per_scale(multiscale, i):
    img, mask, sigmas, ms = multiscale
    assert ms.shape == img.shape + (4, 8)
    single = np.asarray(features8_auto(jnp.asarray(img), jnp.asarray(mask),
                                       sigmas[i], SPACING))
    np.testing.assert_array_equal(ms[..., i, :], single)


@pytest.mark.parametrize("sigma", (0.6, 1.2, 2.4, 4.8))
def test_f32_within_the_device_budget(sigma):
    """The f32 product path against the f64 reference, with the rule and
    budget of the on-device verify phase (gpu_verify.py), on the
    verify phase's data class at an unaligned shape."""
    shape = (26, 22, 21)
    img, mask = gate_scan(shape, seed=3)
    got = np.asarray(features8_auto(jnp.asarray(img, jnp.float32),
                                    jnp.asarray(mask), sigma,
                                    (0.78, 0.78, 1.0)))
    assert got.dtype == np.float32
    want = ref.features8_np(img.astype(np.float64), mask, sigma,
                            (0.78, 0.78, 1.0))
    assert check_within(f"f32 s={sigma}", feature_errors(got, want),
                        BUDGET) < BUDGET


@pytest.mark.parametrize("n_dev,axes,shape,sigma", [
    (1, ("x",), (14, 13, 19), 1.1),
    (2, ("x",), (16, 13, 11), 2.5),       # radius > block: multi-hop halo
    (4, ("x", "y"), (16, 14, 9), 0.9),
    (8, ("x", "y"), (24, 22, 10), 1.2),
])
def test_sharded_faces_match_single_device(n_dev, axes, shape, sigma):
    """Halo-extended shard faces: every block's true-volume faces clamp
    to the smoothed field, interior faces read real neighbour data."""
    img, mask = _data(shape, seed=9)
    mesh = make_mesh(n_dev, axes, devices=jax.devices()[:n_dev])
    got = sharded_features8(shard_volume(jnp.asarray(img), mesh),
                            shard_volume(jnp.asarray(mask), mesh), sigma,
                            mesh, SPACING, stack=False)
    got = np.stack([np.asarray(c) for c in got], -1)
    want = np.asarray(features8(jnp.asarray(img), jnp.asarray(mask), sigma,
                                SPACING))
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-12)
    _assert_features_close(got, want, 1e-9)


def test_sharded_hessian_eig_one_device_mesh():
    img = jnp.asarray(synthetic_ct((14, 13, 11), seed=4,
                                   dtype=jnp.float64).data)
    mesh = make_mesh(1, ("x",), devices=jax.devices()[:1])
    got = np.asarray(sharded_hessian_eig(shard_volume(img, mesh), mesh,
                                         SPACING))
    want = ref.eig_features_np(ref.hessian_np(np.asarray(img), SPACING))
    check_within("sharded hessian_eig", eigen_feature_errors(got, want),
                 1e-9)
