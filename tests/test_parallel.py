"""Multi-device parity: sharded ops on the 8-device CPU mesh must agree
with the single-device ops (SURVEY.md §4: same sharded program on 1 vs N
devices must agree after gather)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ife_tpu.core.volume import synthetic_ct, sphere_mask
from ife_tpu.ops.features import features8, multiscale_features
from ife_tpu.ops.stencil import gaussian_smooth, hessian
from ife_tpu.ops.eigen import eigenvalue_features
from ife_tpu.parallel import (
    halo_pad,
    make_mesh,
    shard_volume,
    sharded_features8,
    sharded_hessian_eig,
    sharded_masked_histogram,
    sharded_multiscale_features,
    histogram_quantile_edges,
)
from ife_tpu.stats.histogram import histogram_counts

SPACING = (0.7, 0.9, 1.2)


def _data(shape=(48, 40, 40), dtype=jnp.float64):
    img = synthetic_ct(shape, seed=5, dtype=dtype)
    mask = sphere_mask(shape, 0.42)
    return img.data, mask.data


@pytest.mark.parametrize("axes", [("x",), ("x", "y")])
def test_sharded_features8_matches_single_device(axes):
    img, mask = _data()
    mesh = make_mesh(8, axes)
    want = np.asarray(features8(img, mask, 1.1, SPACING))
    got = np.asarray(
        sharded_features8(shard_volume(img, mesh), shard_volume(mask, mesh),
                          1.1, mesh, SPACING)
    )
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_sharded_features8_large_sigma_multihop_halo():
    # sigma large enough that the Gaussian radius exceeds the block size
    # (48/8 = 6 planes per shard, radius ~ 4.5*2.5 = 12) -> multi-hop path
    img, mask = _data()
    mesh = make_mesh(8, ("x",))
    want = np.asarray(features8(img, mask, 2.5, SPACING))
    got = np.asarray(
        sharded_features8(shard_volume(img, mesh), shard_volume(mask, mesh),
                          2.5, mesh, SPACING)
    )
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_sharded_hessian_eig_matches_single_device():
    img, _ = _data()
    mesh = make_mesh(8, ("x", "y"))
    want = np.asarray(eigenvalue_features(hessian(img, SPACING)))
    got = np.asarray(sharded_hessian_eig(shard_volume(img, mesh), mesh, SPACING))
    # Tolerance rationale (round-4, measured): the sharded program and
    # ANY single-device reference (eager OR jitted — both were tried)
    # differ by fusion-level f64 rounding that the closed-form eigen
    # solve amplifies at conditioning hotspots of this raw-noise Hessian
    # (sharded-vs-jitted-reference measured 9e-5 abs at this scale —
    # jitting the reference does NOT tighten it). The 1e-5 sorted-set
    # gate is therefore the honest bound for the EIGEN chain; the tight
    # 1e-12 structural gates for sharded boundary/stencil correctness
    # are test_sharded_features8_* (smoothing + gradmag channels) and
    # the halo-exchange tests — a boundary off-by-one fails those, not
    # this.
    np.testing.assert_allclose(np.sort(got[..., :3], axis=-1),
                               np.sort(want[..., :3], axis=-1), atol=1e-5)
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], atol=1e-5)


def test_sharded_multiscale_matches_single_device():
    img, mask = _data((32, 32, 32))
    mesh = make_mesh(4, ("x",), devices=jax.devices()[:4])
    sigmas = (0.8, 1.6)
    want = np.asarray(multiscale_features(img, mask, sigmas, SPACING))
    got = np.asarray(
        sharded_multiscale_features(
            shard_volume(img, mesh), shard_volume(mask, mesh), sigmas, mesh, SPACING
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_halo_pad_is_edge_replication():
    x = jnp.arange(24.0).reshape(4, 3, 2)
    y = halo_pad(x, 0, 2)
    np.testing.assert_array_equal(np.asarray(y[0]), np.asarray(x[0]))
    np.testing.assert_array_equal(np.asarray(y[1]), np.asarray(x[0]))
    np.testing.assert_array_equal(np.asarray(y[-1]), np.asarray(x[-1]))
    assert y.shape == (8, 3, 2)


def test_sharded_masked_histogram_matches_single_device():
    img, mask = _data((32, 32, 32))
    mesh = make_mesh(8, ("x", "y"))
    edges = jnp.asarray(np.linspace(-900, -100, 7))
    want = np.asarray(
        histogram_counts(img, edges, (mask != 0).astype(jnp.float32))
    )
    got = np.asarray(
        sharded_masked_histogram(
            shard_volume(img, mesh), shard_volume(mask, mesh), edges, mesh
        )
    )
    np.testing.assert_allclose(got, want)
    assert got.sum() == float(np.asarray((mask != 0)).sum())


def test_sharded_masked_histogram_chunked_scan_path():
    """Per-shard sizes past histogram_counts' chunk threshold exercise
    the lax.scan accumulator INSIDE shard_map — the path that failed the
    vma check on-chip at 512^3 (round-4 sharded bin-edges CLI) while
    small CPU-test shards sailed through. Fine-grained edges force the
    small-chunk regime so the test stays cheap."""
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.standard_normal((32, 64, 64)), jnp.float32)
    mask = jnp.asarray((rng.uniform(size=(32, 64, 64)) > 0.4), jnp.uint8)
    mesh = make_mesh(2, ("x",))
    edges = jnp.asarray(np.linspace(-3, 3, 4097), jnp.float32)
    # per shard: 16*64*64 = 65536 > the 4097-edge chunk (~32k) -> scan
    want = np.asarray(histogram_counts(img, edges,
                                       (mask != 0).astype(jnp.int32)))
    got = np.asarray(sharded_masked_histogram(
        shard_volume(img, mesh), shard_volume(mask, mesh), edges, mesh))
    np.testing.assert_array_equal(got, want)


def test_masked_fine_histograms_multi_matches_single():
    """The shared-pass multi-channel fine histograms must equal the
    per-channel form exactly (same bounds, same counts)."""
    from ife_tpu.parallel.stats import (
        masked_fine_histogram, masked_fine_histograms_multi,
    )

    rng = np.random.default_rng(6)
    mesh = make_mesh(4, ("x",), devices=jax.devices()[:4])
    chans = tuple(
        shard_volume(jnp.asarray(rng.standard_normal((16, 16, 16)),
                                 jnp.float32), mesh)
        for _ in range(3)
    )
    mask = shard_volume(
        jnp.asarray(rng.uniform(size=(16, 16, 16)) > 0.4, jnp.uint8), mesh)
    multi = masked_fine_histograms_multi(chans, mask, mesh, n_fine=64)
    for c, ch in enumerate(chans):
        b_s, c_s = masked_fine_histogram(ch, mask, mesh, n_fine=64)
        np.testing.assert_allclose(multi[c][0], b_s)
        np.testing.assert_array_equal(multi[c][1], c_s)


def test_masked_fine_histogram_non64_bins_fallback():
    """n_fine not a multiple of 64 cannot take the arithmetic one-hot path;
    the compare-reduce linspace fallback must serve it with the same
    conventions (total == masked count, grid covers the data)."""
    from ife_tpu.parallel.stats import masked_fine_histogram

    rng = np.random.default_rng(13)
    mesh = make_mesh(4, ("x",), devices=jax.devices()[:4])
    v = shard_volume(jnp.asarray(
        rng.standard_normal((16, 16, 16)), jnp.float32), mesh)
    m = shard_volume(jnp.asarray(
        (rng.uniform(size=(16, 16, 16)) > 0.4).astype(np.uint8)), mesh)
    bounds, counts = masked_fine_histogram(v, m, mesh, n_fine=100)
    n_fg = int(np.asarray(m != 0).sum())
    assert counts.size == 100 and counts.sum() == n_fg
    vals = np.asarray(v)[np.asarray(m) != 0]
    assert bounds[0] <= vals.min() and bounds[-1] >= vals.max()
    # linspace fallback grid (not the power-of-two snap)
    np.testing.assert_allclose(np.diff(bounds), np.diff(bounds)[0])


def test_histogram_quantile_edges_approximates_exact():
    rng = np.random.default_rng(0)
    samples = rng.normal(size=200_000)
    pre_edges = np.linspace(-5, 5, 2001)
    counts = np.asarray(histogram_counts(jnp.asarray(samples), jnp.asarray(pre_edges)))
    approx = histogram_quantile_edges(counts, pre_edges, 10)
    exact = np.quantile(samples, np.arange(1, 10) / 10)
    np.testing.assert_allclose(approx, exact, atol=2e-2)
    assert np.all(np.diff(approx) > 0)


def test_features8_sharded_auto_nondivisible_shape():
    # 45x37x24: neither axis divides the 4x2 mesh -> pad-and-crop path
    from ife_tpu.parallel import features8_sharded_auto
    img = synthetic_ct((45, 37, 24), seed=8, dtype=jnp.float64).data
    mask = sphere_mask((45, 37, 24), 0.44).data
    mesh = make_mesh(8, ("x", "y"))
    want = np.asarray(features8(img, mask, 0.9, SPACING))
    got = np.asarray(features8_sharded_auto(img, mask, 0.9, mesh, SPACING))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_merge_fine_histograms_matches_pooled():
    # merging per-source fine histograms on different ranges must reproduce
    # the pooled histogram's CDF to within one source-bin width
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, 100_000)
    b = rng.normal(3, 2, 50_000)
    from ife_tpu.parallel import merge_fine_histograms
    from ife_tpu.stats.equalize import edges_from_dense_counts

    def fine(v, n=2048):
        bounds = np.linspace(v.min(), v.max(), n + 1)
        c, _ = np.histogram(v, bins=bounds)
        return bounds, c.astype(np.float64)

    bounds, counts = merge_fine_histograms([fine(a), fine(b)])
    assert counts.sum() == pytest.approx(150_000)
    approx = edges_from_dense_counts(bounds, counts, 8)
    exact = np.quantile(np.concatenate([a, b]), np.arange(1, 8) / 8)
    np.testing.assert_allclose(approx, exact, atol=4e-2)


def test_sharded_feature_fine_histograms_match_host_quantiles():
    # the full scalable bin-edge pipeline vs exact quantiles of the
    # host-materialized feature volume (the reference's sort path)
    from ife_tpu.parallel import (
        merge_fine_histograms,
        sharded_feature_fine_histograms,
    )
    from ife_tpu.stats.equalize import edges_from_dense_counts

    img, mask = _data((41, 35, 24))  # non-divisible: exercises zero-pad mask
    mesh = make_mesh(8, ("x", "y"))
    sigmas = (1.0,)
    hists = sharded_feature_fine_histograms(
        np.asarray(img), np.asarray(mask), sigmas, mesh, SPACING, n_fine=512
    )
    assert len(hists) == 8
    feats = np.asarray(features8(img, mask, 1.0, SPACING))
    fg = np.asarray(mask) != 0
    n_fg = fg.sum()
    for k, (bounds, counts) in enumerate(hists):
        assert counts.sum() == pytest.approx(n_fg)
        vals = feats[fg][:, k]
        approx = edges_from_dense_counts(bounds, counts, 5)
        exact = np.quantile(vals, np.arange(1, 5) / 5)
        span = vals.max() - vals.min()
        tol = max(span / 512 * 1.5, 1e-12)
        np.testing.assert_allclose(approx, exact, atol=tol)


def test_make_bag_sharded_matches_host_bag():
    from ife_tpu.roi.bag import make_bag, make_bag_sharded
    from ife_tpu.roi.generate import generate_random_rois

    img, mask = _data((41, 35, 24))
    img_np = np.asarray(img, np.float32)
    mask_np = np.asarray(mask).astype(np.uint8)
    rois = generate_random_rois(mask_np, n=6, size=(9, 9, 9), seed=3)
    sigmas = (1.0,)
    rng = np.random.default_rng(2)
    hist_edges = [np.sort(rng.normal(0, 50, 5)) for _ in range(8)]
    mesh = make_mesh(8, ("x", "y"))
    want = make_bag(img_np, mask_np, sigmas, hist_edges, rois, SPACING)
    got = make_bag_sharded(img_np, mask_np, sigmas, hist_edges, rois, mesh,
                           SPACING)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # mixed ROI sizes: per-size-class device programs, same rows
    R = type(rois[0])
    mixed = rois[:3] + [R(rois[3].index, (5, 7, 5)),
                        R(rois[4].index, (5, 7, 5)), rois[5]]
    want_m = make_bag(img_np, mask_np, sigmas, hist_edges, mixed, SPACING)
    got_m = make_bag_sharded(img_np, mask_np, sigmas, hist_edges, mixed,
                             mesh, SPACING)
    np.testing.assert_allclose(got_m, want_m, atol=1e-6)


def test_sharded_runs_are_bitwise_deterministic():
    # SURVEY.md §5 race-detection analog: JAX forbids data races by
    # construction, so the determinism contract we CAN and DO enforce is
    # bitwise run-to-run reproducibility of the sharded program — the
    # collective schedule and the integer psum reductions must not
    # introduce any ordering nondeterminism.
    img, mask = _data((32, 32, 32), jnp.float32)
    mesh = make_mesh(8, ("x", "y"))
    xi = shard_volume(img, mesh)
    mi = shard_volume(mask, mesh)
    edges = jnp.asarray(np.linspace(-900.0, -100.0, 7), jnp.float32)

    def run():
        f = sharded_features8(xi, mi, 1.0, mesh, SPACING)
        h = sharded_masked_histogram(f[..., 0], mi, edges, mesh)
        return np.asarray(f), np.asarray(h)

    f1, h1 = run()
    f2, h2 = run()
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(h1, h2)
    # integer counts: order-independent by construction (int32 psum)
    assert h1.dtype in (np.int32, np.int64)


def test_histogram_reduction_is_order_independent():
    # permuting the shard contents must give the SAME integer counts —
    # the deterministic-reduction property that float accumulation lacks
    img, mask = _data((32, 32, 32), jnp.float32)
    mesh = make_mesh(8, ("x", "y"))
    edges = jnp.asarray(np.linspace(-900.0, -100.0, 7), jnp.float32)
    h_ref = np.asarray(sharded_masked_histogram(
        shard_volume(img, mesh), shard_volume(mask, mesh), edges, mesh))
    # flip both volumes along x: same multiset of (value, mask) pairs,
    # completely different shard-to-device assignment
    h_flip = np.asarray(sharded_masked_histogram(
        shard_volume(img[::-1], mesh), shard_volume(mask[::-1], mesh),
        edges, mesh))
    np.testing.assert_array_equal(h_ref, h_flip)


def test_buffer_donation_aliasing_safe():
    # SURVEY.md §5: donation/aliasing check. Donating the input buffer to
    # the jitted feature pass must neither change the numbers nor let the
    # op read through the donated (now-aliased) buffer incorrectly.
    img, mask = _data((16, 16, 16), jnp.float32)

    def fn(v, m):
        return features8(v, m, 1.0, SPACING)

    want = np.asarray(jax.jit(fn)(img, mask))
    donated_in = jnp.array(img)  # fresh buffer we are allowed to donate
    got = np.asarray(jax.jit(fn, donate_argnums=0)(donated_in, mask))
    np.testing.assert_array_equal(got, want)
    if jax.devices()[0].platform != "cpu":
        # CPU jit ignores donation; on a GPU the buffer must really be
        # donated (aliased away), proving the op never re-reads it
        assert donated_in.is_deleted()
