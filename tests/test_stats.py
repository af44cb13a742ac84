"""Stats tests: ports of the reference's DenseHistogramTest and
DetermineEdgesForEqualizedHistogramTest plus vectorized/JAX paths."""
import numpy as np
import jax.numpy as jnp
import pytest

from ife_tpu.stats.histogram import (
    DenseHistogram,
    histogram_counts,
    batched_histogram_counts,
)
from ife_tpu.stats.equalize import (
    determine_edges_for_equalized_histogram,
    edges_from_dense_counts,
)
from ife_tpu.stats.distance import (
    expected_distance_from_center_to_interest_point,
    signed_distance_map,
)

# values/edges from reference test/DenseHistogramTest.cxx:10-25
VALUES = [-1, 0, 0.5, 1, 1.5, 2.1, 2.6, 2.9, 3.2, 3.5, 4.2, 4.6, 5, 6, 7, 8, 9, 10]
EDGES = [1, 2.5, 3.0, 4.7, 6.2, 8.3]
EXPECTED_COUNTS = [4, 2, 2, 4, 2, 2, 2]


def test_dense_histogram_counts():
    h = DenseHistogram(EDGES)
    for v in VALUES:
        h.insert(v)
    assert h.num_bins == 7
    np.testing.assert_array_equal(h.get_counts(), EXPECTED_COUNTS)


def test_dense_histogram_frequencies():
    h = DenseHistogram(EDGES)
    h.insert_many(VALUES)
    np.testing.assert_allclose(
        h.get_frequencies(), np.array(EXPECTED_COUNTS) / 18.0, rtol=1e-7
    )
    h.reset_counts()
    assert h.get_counts().sum() == 0


def test_dense_histogram_left_open_right_closed():
    """Bin convention: (e_{i-1}, e_i] — a value exactly on an edge goes to
    the bin whose RIGHT edge it is (DenseHistogram.h:22-27,47-53)."""
    h = DenseHistogram([1.0, 2.0])
    h.insert_many([1.0, 2.0, 2.0000001])
    np.testing.assert_array_equal(h.get_counts(), [1, 1, 1])


def test_histogram_counts_jax_matches_host():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(10000) * 3
    edges = np.sort(rng.standard_normal(15))
    got = np.asarray(histogram_counts(jnp.asarray(v), jnp.asarray(edges)))
    h = DenseHistogram(edges)
    h.insert_many(v)
    np.testing.assert_array_equal(got.astype(np.int64), h.get_counts().astype(np.int64))


def test_histogram_counts_weighted_mask():
    v = jnp.asarray([0.5, 1.5, 2.5, 0.7])
    edges = jnp.asarray([1.0, 2.0])
    w = jnp.asarray([1, 1, 1, 0])
    got = np.asarray(histogram_counts(v, edges, w))
    np.testing.assert_array_equal(got, [1, 1, 1])


def test_histogram_counts_exact_past_f32_increment_limit():
    """Counts above 2^24 per bin: an f32 accumulator silently drops +1
    increments there (the production-size failure VERDICT r1 flagged);
    int32 accumulation must stay exact."""
    n = (1 << 24) + 4097
    v = jnp.zeros(n, jnp.float32)
    edges = jnp.asarray([0.5], jnp.float32)
    got = np.asarray(histogram_counts(v, edges))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [n, 0])


def test_histogram_counts_fuzz_vs_searchsorted():
    """The device compare-reduce vs the definitional searchsorted-left
    binning: duplicate edges, values exactly ON edges, +/-inf values,
    weights — all must agree exactly."""
    rng = np.random.default_rng(7)
    edges = np.sort(np.concatenate([rng.standard_normal(9),
                                    [0.5, 0.5]]))  # duplicate edge
    v = np.concatenate([
        rng.standard_normal(5000), edges, [np.inf, -np.inf, 0.5],
    ]).astype(np.float32)
    w = (rng.uniform(size=v.size) > 0.3).astype(np.int32)
    want = np.zeros(edges.size + 1, np.int64)
    np.add.at(want, np.searchsorted(edges.astype(np.float32), v, "left"), w)
    got = np.asarray(histogram_counts(jnp.asarray(v),
                                      jnp.asarray(edges, jnp.float32),
                                      jnp.asarray(w)))
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_histogram_counts_fine_edges_chunked_weighted():
    """Many-edge (fine) histograms force the small-chunk scan path; the
    chunked compare-reduce must stay exact with weights and padding."""
    rng = np.random.default_rng(8)
    edges = np.linspace(-3.0, 3.0, 16400)
    v = rng.standard_normal(20001).astype(np.float32)
    w = (rng.uniform(size=v.size) > 0.5).astype(np.int32)
    want = np.zeros(edges.size + 1, np.int64)
    np.add.at(want, np.searchsorted(edges.astype(np.float32), v, "left"), w)
    got = np.asarray(histogram_counts(jnp.asarray(v),
                                      jnp.asarray(edges, jnp.float32),
                                      jnp.asarray(w)))
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_histogram_counts_integer_values_chunked():
    """Integer values cannot pad with +inf; the zero-weight pad path must
    keep counts exact through the chunked scan."""
    n = (1 << 22) + 17
    v = jnp.asarray(np.arange(n, dtype=np.int32) % 5)
    edges = jnp.asarray([0.0, 2.0, 3.0])
    got = np.asarray(histogram_counts(v, edges))
    base, rem = n // 5, n % 5
    per = [base + (1 if k < rem else 0) for k in range(5)]
    np.testing.assert_array_equal(
        got.astype(np.int64),
        [per[0], per[1] + per[2], per[3], per[4]])


def _oracle(values, edges, weights=None):
    want = np.zeros(len(edges) + 1, np.int64)
    np.add.at(want, np.searchsorted(np.asarray(edges, np.float64),
                                    np.asarray(values, np.float64), "left"),
              1 if weights is None else weights)
    return want


@pytest.mark.parametrize("n", [5000, (1 << 22) + 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_counts_matches_oracle(n, weighted):
    """histogram_counts vs the searchsorted oracle: duplicate edges,
    on-edge values, +/-inf, NaN (tail bin), weighted and unweighted, one
    chunk and the padded multi-chunk scan."""
    rng = np.random.default_rng(9)
    edges = np.sort(np.concatenate([rng.standard_normal(7), [0.25, 0.25]])
                    ).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    v[:3] = [np.inf, -np.inf, np.nan]
    v[3 : 3 + edges.size] = edges
    w = (rng.uniform(size=n) > 0.4).astype(np.int32) if weighted else None
    got = np.asarray(histogram_counts(
        jnp.asarray(v), jnp.asarray(edges),
        None if w is None else jnp.asarray(w)))
    np.testing.assert_array_equal(got.astype(np.int64), _oracle(v, edges, w))


@pytest.mark.parametrize("n_edges", [129, 300, 1000])
def test_histogram_counts_many_edges(n_edges):
    """More edges than one 128-wide block, weighted."""
    rng = np.random.default_rng(10)
    edges = np.linspace(-2.5, 2.5, n_edges).astype(np.float32)
    v = rng.standard_normal(4000).astype(np.float32)
    w = (rng.uniform(size=v.size) > 0.5).astype(np.int32)
    got = np.asarray(histogram_counts(jnp.asarray(v), jnp.asarray(edges),
                                      jnp.asarray(w)))
    np.testing.assert_array_equal(got.astype(np.int64), _oracle(v, edges, w))


@pytest.mark.parametrize("n_edges,weighted", [(3, False), (3, True),
                                              (0, True)])
def test_histogram_counts_empty_input(n_edges, weighted):
    """Zero-length values give zero counts (an empty masked selection)."""
    edges = jnp.asarray(np.arange(n_edges, dtype=np.float32))
    v = jnp.zeros((0,), jnp.float32)
    w = jnp.zeros((0,), jnp.int32) if weighted else None
    got = np.asarray(histogram_counts(v, edges, w))
    np.testing.assert_array_equal(got, np.zeros(n_edges + 1, np.int64))


def test_uniform_histogram_counts_empty_input():
    from ife_tpu.stats.histogram import uniform_histogram_counts

    got = np.asarray(uniform_histogram_counts(
        jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.int32),
        jnp.float32(0), jnp.float32(1), 64))
    np.testing.assert_array_equal(got, np.zeros(64, np.int64))


def test_batched_histogram_counts_weighted():
    """Per-row edges and weights (the multi-channel binning form)."""
    rng = np.random.default_rng(13)
    v = rng.standard_normal((3, 5000)).astype(np.float32)
    edges = np.sort(rng.standard_normal((3, 9)), axis=1).astype(np.float32)
    w = (rng.uniform(size=(3, 5000)) > 0.4).astype(np.int32)
    got = np.asarray(batched_histogram_counts(
        jnp.asarray(v), jnp.asarray(edges), jnp.asarray(w)))
    for c in range(3):
        np.testing.assert_array_equal(got[c].astype(np.int64),
                                      _oracle(v[c], edges[c], w[c]))


def test_snap_pow2_grid_properties():
    """Grid covers [lo, hi], width is a power of two, every edge is
    exactly f32-representable, and the exactness guard trips to None for
    near-constant fields far from zero."""
    from ife_tpu.stats.histogram import snap_pow2_grid

    cases = [(-1000.0, 500.0), (0.0, 1.0), (-3.5e-4, 2.1e-4),
             (1e6, 2e6), (-7.25, -7.0), (0.0, 1e-30)]
    for lo, hi in cases:
        m, k, bounds = snap_pow2_grid(lo, hi, 4096)
        w = np.ldexp(1.0, k)
        assert bounds[0] <= lo and bounds[-1] >= hi, (lo, hi)
        np.testing.assert_array_equal(np.diff(bounds), w)
        np.testing.assert_array_equal(
            bounds.astype(np.float32).astype(np.float64), bounds)
    # near-constant far from zero: |m| blows the 2^22 guard
    assert snap_pow2_grid(1e8, 1e8 + 1.0, 4096) is None
    assert snap_pow2_grid(2.0, 2.0, 4096) is None  # degenerate range


def test_uniform_histogram_counts_exact_vs_searchsorted():
    """The arithmetic one-hot binning must be INTEGER-EXACT against the
    searchsorted-left oracle on its snapped grid: on-edge values,
    zero-crossing ranges, grids far from zero (the Sterbenz-free
    windowed-correction cases), 0/1 weights, and the chunked path."""
    from ife_tpu.stats.histogram import (
        snap_pow2_grid, uniform_histogram_counts,
    )

    rng = np.random.default_rng(21)

    def oracle(v, w01, bounds, n_fine):
        raw = np.zeros(bounds.size + 1, np.int64)
        np.add.at(raw, np.searchsorted(bounds, v.astype(np.float64),
                                       "left"), w01)
        c = raw[1 : n_fine + 1].copy()
        c[0] += raw[0]
        assert raw[n_fine + 1] == 0  # grid covers the data
        return c

    cases = [
        ((-1000.0, 500.0), 4096, 50_000),   # zero-crossing CT-like
        ((1.0e5, 1.3e5), 4096, 30_000),     # large positive m
        ((-9.0, -2.0), 256, 20_000),        # negative range
        ((0.0, 1.0), 64, 10_000),           # m = 0
        ((-2.0e-3, 1.0e-3), 4096, 700_000),  # chunked (> 2^19) + tiny w
    ]
    for (lo, hi), n_fine, n in cases:
        m, k, bounds = snap_pow2_grid(lo, hi, n_fine)
        v = rng.uniform(lo, hi, size=n).astype(np.float32)
        # land many values EXACTLY on edges (and the range ends)
        v[: n_fine + 1] = bounds.astype(np.float32)[: n_fine + 1][
            : min(n, n_fine + 1)]
        v[-2:] = [np.float32(lo), np.float32(hi)]
        w01 = (rng.uniform(size=n) > 0.3).astype(np.int32)
        got = np.asarray(uniform_histogram_counts(
            jnp.asarray(v), jnp.asarray(w01),
            jnp.float32(m), jnp.float32(np.ldexp(1.0, k)), n_fine))
        np.testing.assert_array_equal(
            got.astype(np.int64), oracle(v, w01, bounds, n_fine),
            err_msg=f"range=({lo},{hi}) n_fine={n_fine}")


def test_batched_histogram_counts():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((4, 1000))
    edges = np.sort(rng.standard_normal((4, 7)), axis=-1)
    got = np.asarray(batched_histogram_counts(jnp.asarray(v), jnp.asarray(edges)))
    for i in range(4):
        h = DenseHistogram(edges[i])
        h.insert_many(v[i])
        np.testing.assert_array_equal(got[i].astype(np.int64), h.get_counts())


# --- equalized edges: reference test cases (DetermineEdgesFor...Test.cxx) ---

def test_edges_unique_equalizable():
    edges = determine_edges_for_equalized_histogram(np.arange(1, 10), 3)
    np.testing.assert_array_equal(edges, [4, 7])


def test_edges_all_values_equal():
    edges = determine_edges_for_equalized_histogram(np.ones(8), 2)
    np.testing.assert_array_equal(edges, [1])


def test_edges_uneven_distribution():
    edges = determine_edges_for_equalized_histogram(
        np.array([1, 1, 1, 1, 1, 2, 2, 3, 3, 3]), 3
    )
    np.testing.assert_array_equal(edges, [2, 3])


def test_edges_too_many_bins():
    with pytest.raises(ValueError):
        determine_edges_for_equalized_histogram(np.arange(1, 10), 10)


def test_edges_are_increasing():
    rng = np.random.default_rng(2)
    s = np.sort(rng.uniform(-10, 10, 1000))
    edges = determine_edges_for_equalized_histogram(s, 50)
    assert edges.size == 49
    assert np.all(np.diff(edges) > 0)


def test_edges_equal_bin_occupancy():
    """Property test from the reference (:84-120): on unique samples whose
    count is a multiple of nBins, every bin gets exactly n/nBins samples
    under the convention 'sample changes bin when sample >= edge'."""
    rng = np.random.default_rng(3)
    n_bins = 50
    s = np.unique(rng.uniform(-10, 10, 1000))
    s = s[: s.size - s.size % n_bins]
    edges = determine_edges_for_equalized_histogram(s, n_bins)
    bin_size = s.size // n_bins
    counts = np.zeros(n_bins, dtype=int)
    j = 0
    for v in s:
        if j < edges.size and v >= edges[j]:
            j += 1
        counts[j] += 1
    np.testing.assert_array_equal(counts, bin_size)


def test_edges_from_dense_counts_approximates_exact():
    rng = np.random.default_rng(4)
    s = np.sort(rng.normal(0, 5, 200000))
    exact = determine_edges_for_equalized_histogram(s, 16)
    fine_edges = np.linspace(s.min(), s.max(), 65537)
    counts, _ = np.histogram(s, bins=fine_edges)
    approx = edges_from_dense_counts(fine_edges, counts, 16)
    # fine pre-histogram -> tight agreement with the exact sorted path
    np.testing.assert_allclose(approx, exact, atol=5e-3)


def test_histogram_quantile_edges_matches_spec():
    """The reference-convention adapter must agree with the one CDF
    inversion spec (edges_from_dense_counts) on interior mass."""
    from ife_tpu.parallel.stats import histogram_quantile_edges

    rng = np.random.default_rng(5)
    s = rng.normal(0, 2, 100000)
    edges = np.linspace(-8, 8, 4097)
    # reference convention: E edges -> E+1 counts with unbounded tails
    idx = np.searchsorted(edges, s, side="left")
    counts = np.bincount(idx, minlength=edges.size + 1)
    exact = determine_edges_for_equalized_histogram(np.sort(s), 16)
    approx = histogram_quantile_edges(counts, edges, 16)
    np.testing.assert_allclose(approx, exact, atol=2e-2)


# --- expected distance (C8) ---

def test_signed_distance_sign_convention():
    m = np.zeros((9, 9, 9), dtype=np.uint8)
    m[3:6, 3:6, 3:6] = 1
    sd = signed_distance_map(m, (1, 1, 1))
    assert sd[4, 4, 4] > 0  # inside positive
    assert sd[0, 0, 0] < 0  # outside negative


def test_expected_distance():
    m = np.zeros((9, 9, 9), dtype=np.uint8)
    m[3:6, 3:6, 3:6] = 1
    prob = np.ones_like(m, dtype=np.float64)
    d = expected_distance_from_center_to_interest_point(m, prob)
    sd = signed_distance_map(m)
    np.testing.assert_allclose(d, sd[m != 0].mean())
    assert expected_distance_from_center_to_interest_point(np.zeros((4, 4, 4)), prob[:4, :4, :4]) == 0.0
