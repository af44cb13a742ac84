"""Collective statistics: psum-reduced histograms over a sharded volume.

The reference accumulates samples in a single-thread std::vector and sorts
(DetermineHistogramBinEdges_...cxx:219-296) — the multi-host equivalent
reduces per-shard dense histograms with `psum` and derives quantile edges
from the reduced counts (SURVEY.md §2.4 / §7 hard-part 4). Exact
sort-based edges remain available on a single host via
ife_tpu.stats.equalize.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ife_tpu.parallel.mesh import volume_pspec
from ife_tpu.stats.histogram import histogram_counts


@functools.lru_cache(maxsize=64)
def _masked_histogram_fn(mesh: Mesh):
    """Cached jitted shard_map for one mesh: rebuilding the wrapper per
    call retraces and recompiles the whole program per invocation, once
    for each of the 64 (scale, feature) channels of a bin-edges run; the
    cache turns that into one compile and 63 hits."""
    pspec = volume_pspec(mesh)

    def block(v, m, e):
        w = (m != 0).astype(jnp.int32)
        local = histogram_counts(v, e, w)
        for name in mesh.axis_names:
            local = jax.lax.psum(local, name)
        return local

    # check_vma=False: histogram_counts' chunked lax.scan carries a
    # replicated-zeros accumulator over varying per-shard inputs, which
    # the vma checker rejects (small shards never reach the scan path;
    # tests/test_parallel.py covers it)
    return jax.jit(shard_map(
        block, mesh=mesh, in_specs=(pspec, pspec, P(None)),
        out_specs=P(None), check_vma=False,
    ))


def sharded_masked_histogram(
    values: jax.Array,
    mask: jax.Array,
    edges: jax.Array,
    mesh: Mesh,
) -> jax.Array:
    """Global histogram counts of masked voxels of a sharded volume.

    values: (X, Y, Z) sharded; mask: (X, Y, Z) sharded; edges: (E,)
    replicated. Returns replicated (E+1,) int32 counts == the single-device
    histogram of values[mask != 0] (integer accumulation + integer psum:
    exact at production sizes, unlike an f32 accumulator which drops
    increments past 2^24 per bin).
    """
    return _masked_histogram_fn(mesh)(values, mask, edges)


@jax.jit
def _masked_minmax(v, m):
    """(min, max) of v[m != 0] — module-level jit so repeated fine-
    histogram calls hit the trace cache instead of recompiling."""
    inside = m != 0
    big = jnp.asarray(jnp.inf, v.dtype)
    lo = jnp.where(inside, v, big).min()
    hi = jnp.where(inside, v, -big).max()
    return lo, hi


@functools.lru_cache(maxsize=64)
def _masked_multi_histogram_fn(mesh: Mesh, n_chan: int):
    """Cached jitted shard_map binning n_chan channels in one program,
    each against its own edge row."""
    pspec = volume_pspec(mesh)

    def block(*args):
        chans = args[:n_chan]
        m, e2d = args[n_chan], args[n_chan + 1]
        w = (m != 0).astype(jnp.int32)
        local = jnp.stack([
            histogram_counts(chans[c], e2d[c], w)
            for c in range(n_chan)
        ])
        for name in mesh.axis_names:
            local = jax.lax.psum(local, name)
        return local

    return jax.jit(shard_map(
        block, mesh=mesh,
        in_specs=(pspec,) * n_chan + (pspec, P(None, None)),
        out_specs=P(None, None), check_vma=False,
    ))


def masked_fine_histograms_multi(
    channels,
    mask: jax.Array,
    mesh: Mesh,
    n_fine: int = 4096,
) -> list:
    """masked_fine_histogram for a TUPLE of channels sharing one mask:
    per-channel (bounds, counts), all channels binned by one program
    with the compare-reduce histogram over per-channel edge rows."""
    from ife_tpu.stats.histogram import snap_pow2_grid

    bounds_rows = []
    for ch in channels:
        lo, hi = (float(t) for t in _masked_minmax(ch, mask))
        if not np.isfinite(lo) or not np.isfinite(hi):
            raise ValueError("masked_fine_histograms_multi: empty mask")
        if hi <= lo:
            hi = lo + 1.0
        # SAME grid choice as masked_fine_histogram (the snapped
        # power-of-two grid when it applies) so the two paths return
        # identical (bounds, counts) pairs; the compare-reduce is exact
        # on any f32-representable edges, snapped included
        snapped = (snap_pow2_grid(lo, hi, n_fine)
                   if n_fine % 64 == 0 and ch.dtype == jnp.float32
                   else None)
        bounds_rows.append(snapped[2] if snapped is not None
                           else np.linspace(lo, hi, n_fine + 1))
    bounds2d = np.stack(bounds_rows)
    fn = _masked_multi_histogram_fn(mesh, len(channels))
    raw = np.asarray(
        fn(*channels, mask,
           jnp.asarray(bounds2d, channels[0].dtype)), dtype=np.float64)
    out = []
    for c, bounds in enumerate(bounds_rows):
        counts = raw[c, 1 : n_fine + 1]
        counts[0] += raw[c, 0]
        out.append((bounds, counts))
    return out


def histogram_quantile_edges(
    counts: np.ndarray, edges: np.ndarray, n_bins: int
) -> np.ndarray:
    """Approximate equal-frequency edges from reference-convention counts.

    Adapter over the one CDF-inversion spec, stats.equalize
    .edges_from_dense_counts: `counts` has E+1 entries for E edges (the
    reference bin convention with unbounded tail bins); the tails are
    assigned synthetic finite boundaries one interior-bin-width out, and
    the piecewise-linear CDF is inverted at the n_bins-1 interior
    quantiles. The scalable replacement for the exact global sort
    (documented approximation switch, SURVEY.md §7 hard-part 4).
    """
    from ife_tpu.stats.equalize import edges_from_dense_counts

    counts = np.asarray(counts, dtype=np.float64)
    edges = np.asarray(edges, dtype=np.float64)
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    if counts.size != edges.size + 1:
        raise ValueError(
            f"expected {edges.size + 1} counts for {edges.size} edges, "
            f"got {counts.size}"
        )
    if edges.size < 2:
        raise ValueError("need at least 2 edges to bound the tail bins")
    lo = edges[0] - (edges[1] - edges[0])
    hi = edges[-1] + (edges[-1] - edges[-2])
    bounds = np.concatenate([[lo], edges, [hi]])
    return edges_from_dense_counts(bounds, counts, n_bins)


@functools.lru_cache(maxsize=16)
def _masked_fine_onehot_fn(mesh: Mesh, n_fine: int):
    """Cached jitted shard_map of the arithmetic fine binning
    (stats.histogram.uniform_histogram_counts): the grid scalars (m, w)
    ride as traced PARAMETERS, so ONE compile serves every channel and
    image of the bin-edges pipeline."""
    pspec = volume_pspec(mesh)
    from ife_tpu.stats.histogram import uniform_histogram_counts

    def block(v, m, mf, wf):
        w01 = (m != 0).astype(jnp.int32)
        local = uniform_histogram_counts(v, w01, mf, wf, n_fine)
        for name in mesh.axis_names:
            local = jax.lax.psum(local, name)
        return local

    return jax.jit(shard_map(
        block, mesh=mesh, in_specs=(pspec, pspec, P(), P()),
        out_specs=P(), check_vma=False,
    ))


def masked_fine_histogram(
    values: jax.Array,
    mask: jax.Array,
    mesh: Mesh,
    n_fine: int = 4096,
) -> tuple:
    """(bounds, counts) fine dense histogram of values[mask != 0], computed
    fully on-mesh: a psum min/max pass sets the range, then one binning
    pass fills `n_fine` equal-width bins.

    The bins come from the power-of-two snapped grid
    (stats.histogram.snap_pow2_grid), binned arithmetically with one-hot
    dot accumulation — integer-exact searchsorted semantics without the
    O(n_fine)-per-voxel compare-reduce. When the grid guard trips (near-constant field far from
    zero) or n_fine is not a multiple of 64, the compare-reduce path over
    a linspace grid serves as the exact fallback.

    This is the per-image building block of the scalable bin-edge pipeline
    (replacing the reference's host-side sample vector + global sort,
    tools/DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures.cxx:283).
    Returns (bounds (n_fine+1,) float64, counts (n_fine,) float64).
    """
    lo, hi = (float(t) for t in _masked_minmax(values, mask))
    if not np.isfinite(lo) or not np.isfinite(hi):
        raise ValueError("masked_fine_histogram: mask selects no voxels")
    if hi <= lo:  # constant field: one degenerate bin still inverts cleanly
        hi = lo + 1.0

    from ife_tpu.stats.histogram import snap_pow2_grid

    snapped = (snap_pow2_grid(lo, hi, n_fine)
               if n_fine % 64 == 0 and values.dtype == jnp.float32 else None)
    if snapped is not None:
        m, k, bounds = snapped
        fn = _masked_fine_onehot_fn(mesh, n_fine)
        counts = np.asarray(
            fn(values, mask, jnp.float32(m), jnp.float32(np.ldexp(1.0, k))),
            dtype=np.float64,
        )
        return bounds, counts

    bounds = np.linspace(lo, hi, n_fine + 1)
    raw = np.asarray(
        sharded_masked_histogram(values, mask, jnp.asarray(bounds, values.dtype), mesh),
        dtype=np.float64,
    )
    # reference bin convention (searchsorted-left over n_fine+1 edges) gives
    # n_fine+2 counts: bin 0 holds v == lo exactly, the last tail is empty
    counts = raw[1 : n_fine + 1]
    counts[0] += raw[0]
    return bounds, counts


def merge_fine_histograms(hists, n_out: int | None = None) -> tuple:
    """Merge per-image fine histograms (different ranges) onto one union
    grid by piecewise-linear CDF resampling — the cross-image accumulation
    step of the scalable bin-edge pipeline. Exact when bounds coincide;
    otherwise the error is bounded by one source-bin width.

    Args:
      hists: sequence of (bounds (B_i+1,), counts (B_i,)).
      n_out: union-grid bin count (default: max input resolution).

    Returns (union_bounds (n_out+1,), merged_counts (n_out,)).
    """
    if not hists:
        raise ValueError("no histograms to merge")
    lo = min(float(b[0]) for b, _ in hists)
    hi = max(float(b[-1]) for b, _ in hists)
    if n_out is None:
        n_out = max(len(c) for _, c in hists)
    if hi <= lo:
        hi = lo + 1.0
    union = np.linspace(lo, hi, n_out + 1)
    merged = np.zeros(n_out, dtype=np.float64)
    for bounds, counts in hists:
        cum = np.concatenate([[0.0], np.cumsum(np.asarray(counts, np.float64))])
        cum_u = np.interp(union, np.asarray(bounds, np.float64), cum,
                          left=0.0, right=float(cum[-1]))
        merged += np.diff(cum_u)
    return union, merged


def sharded_feature_fine_histograms(
    image,
    mask,
    sigmas: Sequence[float],
    mesh: Mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
    n_fine: int = 4096,
):
    """Per-(scale, feature) fine histograms of masked feature voxels,
    computed without ever materializing a feature volume on host: features
    stay block-sharded on the mesh, statistics reduce with psum.

    The mask is edge-padded for the FEATURE pass (composes with
    ZeroFluxNeumann, see pad_to_mesh) but zero-padded for COUNTING so pad
    voxels never enter the statistics.

    Returns a scale-major list of length len(sigmas)*8 of (bounds, counts)
    — index i*8+k is scale i, feature k, matching the reference hist-spec
    layout (tools/MakeBag.cxx:453).
    """
    import jax.numpy as jnp

    from ife_tpu.parallel.features import sharded_features8
    from ife_tpu.parallel.mesh import pad_to_mesh, shard_volume

    mask_np = np.asarray(mask)
    img_p, orig = pad_to_mesh(jnp.asarray(image, jnp.float32), mesh)
    msk_feat, _ = pad_to_mesh(jnp.asarray(mask_np), mesh)
    msk_count = np.zeros(img_p.shape[:3], dtype=np.uint8)
    msk_count[: orig[0], : orig[1]] = (mask_np != 0).astype(np.uint8)

    img_s = shard_volume(img_p, mesh)
    mskf_s = shard_volume(msk_feat, mesh)
    mskc_s = shard_volume(jnp.asarray(msk_count), mesh)

    out = []
    for s in sigmas:
        # stack=False: per-channel tuple, the channel-last stack is
        # never materialized; each channel bins on its own snapped grid
        feats = sharded_features8(img_s, mskf_s, float(s), mesh, spacing,
                                  truncate, stack=False)
        for chan in feats:
            out.append(
                masked_fine_histogram(chan, mskc_s, mesh, n_fine)
            )
    return out
