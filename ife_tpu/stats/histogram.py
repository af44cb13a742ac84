"""Dense histograms with fixed edges.

Reference semantics (include/ife/Statistics/DenseHistogram.h:13-78):
n sorted edges define n+1 bins
    (-inf, e0], (e0, e1], ..., (e_{n-1}, +inf)
i.e. bin(x) = index of first edge >= x  ==  searchsorted(edges, x, 'left').
Frequencies are counts / total.

Design: instead of ITK's one-voxel-at-a-time std::lower_bound insert
loop (DenseHistogram.h:47-53, the MakeBag hot loop at
tools/MakeBag.cxx:448-457), binning on device is a CUMULATIVE
COMPARE-REDUCE: C[j] = sum_i w_i * (x_i <= e_j) for each edge, then
counts = diff(C) — pure broadcast-compare + sum reductions that XLA fuses
into one streaming pass. For sorted (nondecreasing) edges this is EXACTLY
searchsorted(edges, x, 'left') binning: idx(x) <= j  <=>  x <= e_j.
Counts accumulate in int32 and psum-reduce across shards (SURVEY.md §2.4).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp


def histogram_counts(
    values: jnp.ndarray,
    edges: jnp.ndarray,
    weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Counts over n+1 bins for n edges, reference bin convention.

    Accumulates in int32: a float32 accumulator silently drops +1
    increments past 2^24 ≈ 16.7M counts per bin — a real failure mode at
    production volume sizes (a 512³ dense masked histogram has 1.3e8
    voxels). int32 is exact to 2.1e9 per bin and psum-reduces across
    shards natively (semantics anchor: integer counts in reference
    DenseHistogram.h:47-53).

    Args:
      values: any shape; flattened.
      edges: (E,) sorted ascending.
      weights: optional same shape as values — nonnegative integer
        weights (cast to int32; in the product paths a 0/1 mask).
        Fractional weights are not supported; the weights are summed,
        not reduced as booleans.

    Returns:
      (E+1,) int32 counts.
    """
    v = values.reshape(-1)
    w = None if weights is None else weights.reshape(-1).astype(jnp.int32)
    E = int(edges.shape[0])
    if E == 0:
        tot = (jnp.asarray(v.shape[0], jnp.int32) if w is None
               else jnp.sum(w, dtype=jnp.int32))
        return tot[None]

    def chunk_counts(vv, ww):
        """Cumulative compare-reduce over one chunk: (E,) int32 C[j] =
        sum w*(v <= e_j), plus the chunk total. The (E, chunk) compare
        never materializes — XLA fuses the broadcast-compare producer
        into the row reductions."""
        le = vv[None, :] <= edges[:, None]          # (E, chunk) predicate
        if ww is None:
            cum = jnp.sum(le, axis=1, dtype=jnp.int32)
            tot = jnp.asarray(vv.shape[0], jnp.int32)
        else:
            cum = jnp.sum(le * ww[None, :], axis=1, dtype=jnp.int32)
            tot = jnp.sum(ww, dtype=jnp.int32)
        return cum, tot

    # chunk the scan so the fused compare stays cache-sized; smaller
    # chunks for many-edge (fine) histograms bound the per-step compute
    chunk = max(1 << 13, min(1 << 22, (1 << 27) // max(E, 1)))
    n = v.shape[0]
    if n > chunk:
        pad = (-n) % chunk
        inexact = jnp.issubdtype(v.dtype, jnp.inexact)
        if pad:
            if inexact:
                # pad values with +inf: they fall past every edge, and
                # their spurious +pad in the total is subtracted below
                vc = jnp.pad(v, (0, pad), constant_values=np.inf)
                wc = None if w is None else jnp.pad(w, (0, pad))
            else:
                # integer values have no +inf — pad with zero WEIGHT so
                # the pads never count anywhere
                vc = jnp.pad(v, (0, pad))
                wc = jnp.pad(w if w is not None
                             else jnp.ones_like(v, jnp.int32), (0, pad))
        else:
            vc, wc = v, w
        vc = vc.reshape(-1, chunk)
        xs = (vc,) if wc is None else (vc, wc.reshape(-1, chunk))

        def body(acc, args):
            cum, tot = chunk_counts(args[0], args[1] if len(args) > 1
                                    else None)
            return (acc[0] + cum, acc[1] + tot), None

        acc0 = (jnp.zeros(E, jnp.int32), jnp.zeros((), jnp.int32))
        (cum, tot), _ = jax.lax.scan(body, acc0, xs)
        if pad and inexact and w is None:
            tot = tot - pad  # the +inf pads counted into the total
    else:
        cum, tot = chunk_counts(v, w)
    first = cum[:1]
    interior = cum[1:] - cum[:-1]
    tail = (tot - cum[-1])[None]
    return jnp.concatenate([first, interior, tail])


def batched_histogram_counts(
    values: jnp.ndarray, edges: jnp.ndarray, weights: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Many histograms at once: values (H, N), edges (H, E) -> (H, E+1)."""
    fn = jax.vmap(histogram_counts,
                  in_axes=(0, 0, None if weights is None else 0))
    return fn(values, edges, weights)


# ---------------------------------------------------------------------------
# fine (many-bin) equal-width histograms: arithmetic binning + one-hot dot
# ---------------------------------------------------------------------------

# one-hot operand dtype of the accumulation dot: 0/1 values are exact in
# bf16, and the dot accumulates in f32, exact to 2^24 per chunk
_ONEHOT_DTYPE = jnp.bfloat16

def snap_pow2_grid(lo: float, hi: float, n_fine: int):
    """Snap [lo, hi] to a power-of-two uniform grid e_j = (m + j)·w,
    j = 0..n_fine, with w = 2^k and m integer: the edge set for which
    searchsorted-left binning reduces EXACTLY to f32 arithmetic (see
    uniform_histogram_counts). Returns (m, k, bounds_f64) — every e_j is
    exactly f32-representable — or None when the grid cannot satisfy the
    exactness guard |m| + n_fine + 2 <= 2^22 (a near-constant field far
    from zero: range/|lo| < ~2^-10; callers fall back to the
    compare-reduce path there).

    The grid covers at least [lo, hi] (e_0 <= lo, e_{n_fine} >= hi) and
    at most twice its width — the CDF-inversion consumers of the scalable
    bin-edge pipeline take (bounds, counts) pairs, so a widened grid only
    halves (at worst) the fine resolution, bounded like any other
    source-bin-width error of the merge step.
    """
    lo = float(lo)
    hi = float(hi)
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo or n_fine < 1:
        return None
    # w >= range/(n_fine-1) guarantees e_{n_fine} = e_0 + n_fine*w >= hi
    # even with e_0 = lo - (w - ulp)
    k = int(np.ceil(np.log2((hi - lo) / max(n_fine - 1, 1))))
    if not (-120 <= k <= 120):  # stay far from f32 subnormal/overflow
        return None
    w = float(np.ldexp(1.0, k))
    m = int(np.floor(lo / w))
    if abs(m) + n_fine + 2 > (1 << 22):
        return None
    bounds = (m + np.arange(n_fine + 1, dtype=np.float64)) * w
    return m, k, bounds


def uniform_histogram_counts(
    values: jnp.ndarray,
    weights01: jnp.ndarray,
    m: jnp.ndarray,
    w: jnp.ndarray,
    n_fine: int,
) -> jnp.ndarray:
    """Merged-tail counts over the power-of-two grid of snap_pow2_grid:
    (n_fine,) int32, bin b = {x : e_b < x <= e_{b+1}} with bin 0
    additionally holding x <= e_0 — exactly the reference searchsorted
    convention (DenseHistogram.h:13-78) after the fine pipeline's
    tail-merge (counts[0] += raw[0]; the upper tail is empty because the
    grid covers [lo, hi]).

    Replacement for the O(E)-per-voxel compare-reduce at large E: on THIS
    edge family the bin index is pure arithmetic — d = (x - e_0)·2^-k, floor, then a 3-edge
    windowed correction where each candidate edge is RECONSTRUCTED as
    (m + j)·w (exact in f32: |m| + j <= 2^22 by the snap guard, w a power
    of two — no gathers, no Sterbenz assumptions; fl(x - e_0) may round,
    which only perturbs the candidate by ±1, and the correction compares
    x against exact edge VALUES). Accumulation is a matrix product: the
    index splits into coarse (b >> 6) and fine (b & 63) halves, their
    one-hot rows (chunk, 64) — exact in bf16, 0/1 entries — meet in one
    dot_general per chunk, accumulating all n_fine bins in f32 (exact to
    2^24 per chunk) — ~130 elementwise ops + 2·64·64 flops per voxel
    instead of n_fine compares.

    Args:
      values: f32, any shape (flattened).
      weights01: SAME size, 0/1 weights (the mask convention of the fine
        pipeline — general integer weights belong to histogram_counts).
      m, w: the snapped grid's integer offset and bin width (from
        snap_pow2_grid), as 0-d f32 arrays — traced PARAMETERS, so one
        compile serves every (channel, image) grid.
      n_fine: static bin count, a multiple of 64.
    """
    if n_fine % 64:
        raise ValueError("n_fine must be a multiple of 64")
    G = n_fine // 64
    v = values.reshape(-1).astype(jnp.float32)
    w01 = weights01.reshape(-1).astype(jnp.int32)
    mf = jnp.asarray(m, jnp.float32)
    wf = jnp.asarray(w, jnp.float32)
    inv_w = 1.0 / wf  # reciprocal of a power of two: exact
    L = mf * wf       # e_0; |m| <= 2^22 -> exact

    iota_c = jnp.arange(G, dtype=jnp.int32)[None, :]
    iota_f = jnp.arange(64, dtype=jnp.int32)[None, :]

    def block_counts(x, ww):
        d = (x - L) * inv_w
        d = jnp.where(jnp.isnan(d), 0.0, d)  # weight-0 lanes only
        j0 = jnp.clip(jnp.floor(d), 0.0, float(n_fine))
        # windowed correction: the true bin b = #{e_j < x} is within 1 of
        # floor(d) (|fl(x-e_0)·inv_w - d_true| < 2^-12 here), and each
        # (m + j0 + t)·w below is the exact f64 edge value, so the three
        # comparisons pin b exactly
        b = j0.astype(jnp.int32) - 1
        for t in (-1.0, 0.0, 1.0):
            b = b + (x > (mf + (j0 + t)) * wf)
        ob = jnp.clip(b, 1, n_fine) - 1  # tail merge + garbage clamp
        c = ob >> 6
        f = ob & 63
        dt = _ONEHOT_DTYPE
        ohc = ((c[:, None] == iota_c) & (ww[:, None] != 0)).astype(dt)
        ohf = (f[:, None] == iota_f).astype(dt)
        # two (chunk, 64) one-hot operands meeting in one dot; 0/1 bf16
        # operands with f32 accumulation are exact, so no precision
        # setting is needed here (unlike the f32 smoothing conv)
        return jax.lax.dot_general(
            ohc, ohf, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (G, 64) exact integer-valued

    chunk = 1 << 19
    n = v.shape[0]
    if n <= chunk:
        acc = (block_counts(v, w01).astype(jnp.int32) if n
               else jnp.zeros((G, 64), jnp.int32))
    else:
        pad = (-n) % chunk
        if pad:  # pad weight 0: lands in some bin with zero contribution
            v = jnp.pad(v, (0, pad))
            w01 = jnp.pad(w01, (0, pad))
        vc = v.reshape(-1, chunk)
        wc = w01.reshape(-1, chunk)

        # int32 carry: each chunk's f32 matmul counts are exact (< 2^19
        # per bin), but the cross-chunk total can pass 2^24
        def body(acc, xs):
            return acc + block_counts(xs[0], xs[1]).astype(jnp.int32), None

        acc, _ = jax.lax.scan(body, jnp.zeros((G, 64), jnp.int32),
                              (vc, wc))
    return acc.reshape(-1)


class DenseHistogram:
    """Host-side accumulating histogram mirroring the reference class API
    (insert / get_counts / get_frequencies / reset_counts), but with
    vectorized bulk inserts.

    Reference: DenseHistogram.h:13-78. getFrequencies divides by the total
    count (an integer sum, DenseHistogram.h:55-60).
    """

    def __init__(self, edges: Sequence[float]):
        e = np.asarray(list(edges), dtype=np.float64)
        if e.size < 1:
            raise ValueError("DenseHistogram needs at least one edge")
        self._edges = e
        self._counts = np.zeros(e.size + 1, dtype=np.uint64)

    @property
    def edges(self) -> np.ndarray:
        return self._edges

    @property
    def num_bins(self) -> int:
        return self._counts.size

    def insert(self, value) -> None:
        self.insert_many(np.atleast_1d(np.asarray(value)))

    def insert_many(self, values, weights=None) -> None:
        """Vectorized bulk insert (weights must be nonneg ints if given)."""
        v = np.asarray(values).reshape(-1)
        # f32 only: the C path bins float32, which could land f64 values in
        # a neighbor bin right at an edge
        if weights is None and v.size > (1 << 16) and v.dtype == np.float32:
            # threaded C++ binning when built (ife_tpu/native_lib.py)
            from ife_tpu.native_lib import histogram_native

            counts = histogram_native(v, self._edges)
            if counts is not None:
                self._counts += counts
                return
        idx = np.searchsorted(self._edges, v, side="left")
        if weights is None:
            binc = np.bincount(idx, minlength=self._counts.size)
        else:
            binc = np.bincount(
                idx, weights=np.asarray(weights).reshape(-1), minlength=self._counts.size
            )
        self._counts += binc.astype(np.uint64)

    def get_counts(self) -> np.ndarray:
        return self._counts.copy()

    def get_frequencies(self) -> np.ndarray:
        total = self._counts.sum()
        if total == 0:
            # reference divides by zero -> nan/inf; we keep 0/0 IEEE semantics
            with np.errstate(divide="ignore", invalid="ignore"):
                return self._counts / np.float64(total)
        return self._counts / np.float64(total)

    def reset_counts(self) -> None:
        self._counts[:] = 0

    def __str__(self) -> str:
        # reference operator<< writes comma-separated counts (DenseHistogram.h:80-84)
        return ",".join(str(int(c)) for c in self._counts)
