"""ROI generation + bag assembly tests (distributional parity per
SURVEY.md §7 quirk 6; exact layout parity for bag columns)."""
import numpy as np
import pytest

from ife_tpu.roi.generate import ROI, generate_random_rois, generate_dense_rois
from ife_tpu.roi.bag import (
    make_bag,
    make_bag_intensity,
    sample_rois,
    extract_labels,
    _roi_frequencies,
)
from ife_tpu.core.volume import synthetic_ct, sphere_mask


def test_random_rois_properties():
    mask = np.zeros((40, 40, 40), dtype=np.uint8)
    mask[10:30, 10:30, 10:30] = 1
    size = (9, 9, 9)
    rois = generate_random_rois(mask, 25, size, seed=0)
    assert len(rois) == 25
    for r in rois:
        assert r.size == size
        # box fully inside
        assert all(i >= 0 for i in r.index)
        assert all(i + s <= 40 for i, s in zip(r.index, r.size))
        # center is a foreground voxel
        center = tuple(i + s // 2 for i, s in zip(r.index, r.size))
        assert mask[center] != 0


def test_random_rois_empty_mask_raises():
    with pytest.raises(ValueError):
        generate_random_rois(np.zeros((8, 8, 8)), 3, (3, 3, 3), seed=0)


def test_dense_rois():
    mask = np.zeros((12, 12, 12), dtype=np.uint8)
    mask[5:8, 5:7, 6] = 1
    rois = generate_dense_rois(mask, (3, 3, 3))
    # every foreground voxel whose box fits is a center
    n_fg = int((mask != 0).sum())
    assert len(rois) == n_fg
    centers = {tuple(i + 1 for i in r.index) for r in rois}
    fg = {tuple(c) for c in np.argwhere(mask != 0)}
    assert centers == fg


def test_dense_rois_excludes_border():
    mask = np.ones((5, 5, 5), dtype=np.uint8)
    rois = generate_dense_rois(mask, (3, 3, 3))
    # only centers with full 3^3 box inside: 3^3 = 27
    assert len(rois) == 27


def test_roi_start_uses_integer_halving():
    """start = center - size/2 with integer division (even sizes shift)."""
    mask = np.zeros((20, 20, 20), dtype=np.uint8)
    mask[10, 10, 10] = 1
    rois = generate_dense_rois(mask, (4, 4, 4))
    assert rois[0].index == (8, 8, 8)


def test_roi_frequencies_convention():
    freqs = _roi_frequencies(np.array([0.5, 1.0, 1.5, 2.5]), np.array([1.0, 2.0]))
    np.testing.assert_allclose(freqs, [2 / 4, 1 / 4, 1 / 4])


def test_make_bag_layout():
    """Column layout: histIdx = scale*8 + feature, offset histIdx*histSize
    (reference MakeBag.cxx:453-470)."""
    shape = (24, 24, 24)
    img = synthetic_ct(shape, seed=5).numpy()
    mask = sphere_mask(shape, 0.4).numpy()
    sigmas = [0.7, 1.4]
    n_hists = 8 * len(sigmas)
    hist_edges = [np.array([-10.0, 0.0, 10.0]) for _ in range(n_hists)]
    hist_size = 4
    rois = generate_random_rois(mask, 3, (7, 7, 7), seed=1)
    bag = make_bag(img, mask, sigmas, hist_edges, rois)
    assert bag.shape == (3, hist_size * n_hists)
    # each row is a concatenation of per-histogram frequency blocks summing to 1
    for j in range(3):
        for h in range(n_hists):
            block = bag[j, h * hist_size : (h + 1) * hist_size]
            np.testing.assert_allclose(block.sum(), 1.0, rtol=1e-6)


def test_make_bag_hist_count_mismatch_raises():
    img = np.zeros((8, 8, 8), dtype=np.float32)
    mask = np.ones((8, 8, 8), dtype=np.uint8)
    with pytest.raises(ValueError):
        make_bag(img, mask, [1.0], [np.array([0.0])] * 7, [ROI((0, 0, 0), (4, 4, 4))])


def test_make_bag_intensity():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 10, (10, 10, 10))
    mask = np.ones((10, 10, 10), dtype=np.uint8)
    rois = [ROI((0, 0, 0), (5, 5, 5)), ROI((5, 5, 5), (5, 5, 5))]
    bag = make_bag_intensity(img, mask, np.array([5.0]), rois)
    assert bag.shape == (2, 2)
    np.testing.assert_allclose(bag.sum(1), 1.0)
    np.testing.assert_allclose(
        bag[0, 0], (img[:5, :5, :5] <= 5.0).mean(), rtol=1e-12
    )


def test_sample_rois_scan_order():
    img = np.arange(4 * 4 * 4, dtype=np.float64).reshape(4, 4, 4)
    rois = [ROI((0, 0, 0), (2, 2, 2))]
    rows = sample_rois(img, rois)
    # ITK scan order x fastest: [000,100,010,110,001,101,011,111]
    want = [
        img[0, 0, 0], img[1, 0, 0], img[0, 1, 0], img[1, 1, 0],
        img[0, 0, 1], img[1, 0, 1], img[0, 1, 1], img[1, 1, 1],
    ]
    np.testing.assert_array_equal(rows[0], want)


def test_extract_labels_mode_and_ignore():
    lab = np.zeros((6, 6, 6), dtype=np.int32)
    lab[:2] = 2      # 72 voxels
    lab[3:, :3] = 5  # 54 voxels; remaining 0s: 90 voxels
    rois = [ROI((0, 0, 0), (6, 6, 6))]
    assert extract_labels(lab, rois) == [0]  # 0 is the most common
    assert extract_labels(lab, rois, ignore=[0]) == [2]
    assert extract_labels(lab, rois, ignore=[0, 2]) == [5]
    # dominant override
    assert extract_labels(lab, rois, ignore=[0], dominant=5, dominant_threshold=0.1) == [5]


def test_roi_feature_histograms_device_matches_host():
    import jax.numpy as jnp
    from ife_tpu.roi.bag import make_bag, roi_feature_counts_device
    from ife_tpu.ops.features import features8
    from ife_tpu.core.volume import synthetic_ct, sphere_mask
    from ife_tpu.roi.generate import generate_random_rois

    vol = synthetic_ct((24, 24, 24), seed=3)
    mask = sphere_mask((24, 24, 24), 0.45)
    rois = generate_random_rois(mask.numpy(), n=4, size=(7, 7, 7), seed=0)
    edges = np.stack([np.linspace(-700 + 30 * k, -100, 5) for k in range(8)])

    bag_host = make_bag(vol.numpy(), mask.numpy(), [1.0], list(edges), rois)

    feats = features8(vol.data, mask.data, 1.0)
    starts = jnp.asarray([r.index for r in rois])
    counts, totals = roi_feature_counts_device(
        feats, mask.data, starts, jnp.asarray(edges), (7, 7, 7)
    )
    freqs = np.asarray(counts) / np.asarray(totals)[:, None, None]
    np.testing.assert_allclose(freqs.reshape(4, -1), bag_host, atol=1e-6)


def test_make_bag_device_matches_host():
    from ife_tpu.roi.bag import make_bag_device

    vol = synthetic_ct((24, 24, 24), seed=3)
    mask = sphere_mask((24, 24, 24), 0.45)
    rois = generate_random_rois(mask.numpy(), n=4, size=(7, 7, 7), seed=0)
    sigmas = [0.7, 1.3]
    edges = [np.linspace(-700 + 30 * k, -100, 5) for k in range(16)]
    host = make_bag(vol.numpy(), mask.numpy(), sigmas, edges, rois)
    dev = make_bag_device(vol.numpy(), mask.numpy(), sigmas, edges, rois)
    np.testing.assert_allclose(dev, host, atol=1e-6)


def test_make_bag_device_mixed_roi_sizes():
    """Reference `.ROIInfo` files carry PER-ROI sizes (MakeBag.cxx:
    304-317); the device path buckets by size class and must match the
    host bag row-for-row (round-4 VERDICT weak-5: mixed sizes silently
    fell to the 7x-slower host path)."""
    from ife_tpu.roi.bag import make_bag_device

    vol = synthetic_ct((24, 24, 24), seed=3)
    mask = sphere_mask((24, 24, 24), 0.45)
    base = generate_random_rois(mask.numpy(), n=5, size=(7, 7, 7), seed=0)
    R = type(base[0])
    mixed = [base[0], R(base[1].index, (5, 5, 5)), base[2],
             R(base[3].index, (5, 9, 3)), R(base[4].index, (5, 5, 5))]
    sigmas = [0.7, 1.3]
    edges = [np.linspace(-700 + 30 * k, -100, 5) for k in range(16)]
    host = make_bag(vol.numpy(), mask.numpy(), sigmas, edges, mixed)
    dev = make_bag_device(vol.numpy(), mask.numpy(), sigmas, edges, mixed)
    np.testing.assert_allclose(dev, host, atol=1e-6)
