"""Halo exchange: the stencil-parallel primitive.

Inside a `shard_map`, a block needs `h` neighbor planes along each sharded
axis before a radius-`h` stencil can produce its kept region. Interior
block faces receive real neighbor slabs via `lax.ppermute` (nearest-
neighbor traffic, ring-attention style); true volume faces replicate
the boundary plane — exactly ITK's ZeroFluxNeumann condition (reference
tools/FiniteDifference_HessianFeatures.cxx:4-7), so a sharded stencil is
bit-compatible with the single-device ops in ife_tpu.ops.stencil.

The reference has no analog (single address space, SURVEY.md §2.4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _slab(x: jnp.ndarray, axis: int, start: int, size: int) -> jnp.ndarray:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, start + size) if start >= 0 else slice(start, None)
    return x[tuple(idx)]


def _edge(x: jnp.ndarray, axis: int, h: int, lo: bool) -> jnp.ndarray:
    """h replicated copies of the boundary plane (ZeroFluxNeumann)."""
    plane = _slab(x, axis, 0, 1) if lo else _slab(x, axis, x.shape[axis] - 1, 1)
    return jnp.concatenate([plane] * h, axis=axis)


def halo_pad(x: jnp.ndarray, axis: int, h: int) -> jnp.ndarray:
    """Single-device fallback: pure edge replication (no mesh axis)."""
    return jnp.concatenate([_edge(x, axis, h, True), x, _edge(x, axis, h, False)], axis=axis)


def halo_exchange(
    x: jnp.ndarray, axis: int, h: int, axis_name: str
) -> jnp.ndarray:
    """Extend a block by h planes per side along `axis` (shard_map context).

    Fast path (h <= block size): one slab ppermute per direction. Slow path
    (tiny blocks, h > block size — test meshes): multi-hop full-block
    ppermutes, with edge replication cascading past the boundary shards.
    """
    if h <= 0:
        return x
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    n_local = x.shape[axis]

    if h <= n_local:
        right_perm = [(j, j + 1) for j in range(n - 1)]  # data flows rightward
        left_perm = [(j, j - 1) for j in range(1, n)]    # data flows leftward
        from_left = lax.ppermute(_slab(x, axis, n_local - h, h), axis_name, right_perm)
        from_right = lax.ppermute(_slab(x, axis, 0, h), axis_name, left_perm)
        lo = jnp.where(i == 0, _edge(x, axis, h, True), from_left)
        hi = jnp.where(i == n - 1, _edge(x, axis, h, False), from_right)
        return jnp.concatenate([lo, x, hi], axis=axis)

    # multi-hop path: pull k-th neighbor blocks until h planes are covered
    hops = -(-h // n_local)
    lo_blocks, hi_blocks = [], []
    lo_prev, hi_prev = x, x
    for k in range(1, hops + 1):
        right_perm = [(j, j + k) for j in range(n - k)]
        left_perm = [(j, j - k) for j in range(k, n)]
        recv_lo = lax.ppermute(x, axis_name, right_perm)
        recv_hi = lax.ppermute(x, axis_name, left_perm)
        # shards with no k-away neighbor fall back to replicating the edge
        # plane of the nearest previously-assembled block — this propagates
        # the TRUE global edge plane outward, not a local one.
        lo_k = jnp.where(i >= k, recv_lo, _edge(lo_prev, axis, n_local, True))
        hi_k = jnp.where(i < n - k, recv_hi, _edge(hi_prev, axis, n_local, False))
        lo_blocks.append(lo_k)
        hi_blocks.append(hi_k)
        lo_prev, hi_prev = lo_k, hi_k
    lo_full = jnp.concatenate(lo_blocks[::-1], axis=axis)  # far -> near
    hi_full = jnp.concatenate(hi_blocks, axis=axis)        # near -> far
    lo = _slab(lo_full, axis, lo_full.shape[axis] - h, h)
    hi = _slab(hi_full, axis, 0, h)
    return jnp.concatenate([lo, x, hi], axis=axis)
