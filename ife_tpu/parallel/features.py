"""Sharded (multi-device) feature ops: the single-device ops of
ife_tpu.ops re-expressed over a block-sharded voxel grid.

Design (new — the reference is single-node, SURVEY.md §2.4):
  * the volume is block-sharded along X (1D mesh) or X,Y (2D mesh); Z —
    the minor, contiguous axis — stays local;
  * Gaussian smoothing along a sharded axis = radius-R halo exchange + a
    VALID convolution producing exactly the kept region (the halo's edge
    replication reproduces ITK's ZeroFluxNeumann clamp, so results match
    the single-device edge-pad + convolution);
  * all finite differences after smoothing need radius 1 per axis — one
    more halo exchange of the smoothed field, then every derivative
    (including the cascaded cross terms Dx→Dy etc., reference
    Hessian3DImageFilter.hxx:31-59) is local, consuming the halo exactly
    once per axis;
  * eigen features / masking are elementwise-local;
  * per-block results compose into the same (X, Y, Z, 8) global array as
    ops.features.features8 — parity is tested on the 8-device CPU mesh.

The halo exchange and psum collectives are XLA collectives: on a GPU host
XLA hands them to NCCL over NVLink, on the CPU mesh to its own transport.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ife_tpu.ops import stencil
from ife_tpu.ops.eigen import eigenvalue_features
from ife_tpu.parallel.halo import halo_exchange, _slab
from ife_tpu.parallel.mesh import volume_pspec


# ---------------------------------------------------------------------------
# Gaussian on an extended block
# ---------------------------------------------------------------------------

def _smooth_axis_block(
    x: jnp.ndarray, axis: int, axis_name: str, sigma: float, spacing: float,
    truncate: float,
) -> jnp.ndarray:
    """Gaussian along a SHARDED axis: halo exchange + VALID convolution —
    the halo (real neighbor slabs / edge replication at true edges) plays
    exactly the role of stencil.gaussian_smooth_axis's edge pad, so results
    match the single-device op."""
    if sigma <= 0:
        return x
    sigma_vox = float(sigma) / float(spacing)
    radius = stencil.gaussian_radius(sigma_vox, truncate)
    x_ext = halo_exchange(x, axis, radius, axis_name)
    return stencil.convolve_valid_axis(x_ext, axis, sigma_vox, radius)


# ---------------------------------------------------------------------------
# finite differences on halo-extended blocks
# ---------------------------------------------------------------------------

Exts = Dict[int, int]  # axis -> current halo width carried by the array


def _d(arr: jnp.ndarray, exts: Exts, axis: int, order: int, h: float
       ) -> Tuple[jnp.ndarray, Exts]:
    """Central difference along `axis`. Consumes the axis's halo level if it
    has one; otherwise ZeroFluxNeumann edge padding (correct only for
    unsharded axes / true edges — callers guarantee that)."""
    if exts.get(axis, 0) > 0:
        n_out = arr.shape[axis] - 2
        fm = _slab(arr, axis, 0, n_out)
        f0 = _slab(arr, axis, 1, n_out)
        fp = _slab(arr, axis, 2, n_out)
        # same f64-folded reciprocal constants as stencil.derivative so the
        # sharded and single-device paths agree to the ulp
        hf = float(h)
        if order == 1:
            out = (fp - fm) * jnp.asarray(1.0 / (2.0 * hf), arr.dtype)
        else:
            out = (fp - 2 * f0 + fm) * jnp.asarray(1.0 / (hf * hf), arr.dtype)
        new = dict(exts)
        new.pop(axis)
        return out, new
    return stencil.derivative(arr, axis, order, h), dict(exts)


def _crop(arr: jnp.ndarray, exts: Exts) -> jnp.ndarray:
    """Drop any remaining halo extensions, yielding the kept block."""
    for axis, hh in exts.items():
        if hh > 0:
            arr = _slab(arr, axis, hh, arr.shape[axis] - 2 * hh)
    return arr


def _grad_hessian_block(
    s: jnp.ndarray, sharded_axes: Dict[int, str], spacing: Sequence[float]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gradient magnitude, 6-channel Hessian) of a block, matching
    stencil.gradient_magnitude / stencil.hessian globally."""
    E = s
    exts: Exts = {}
    for axis, name in sharded_axes.items():
        E = halo_exchange(E, axis, 1, name)
        exts[axis] = 1

    def D(arr, ex, axis, order):
        return _d(arr, ex, axis, order, spacing[axis])

    gs = []
    for axis in range(3):
        g, rem = D(E, exts, axis, 1)
        gs.append(_crop(g, rem))
    gm = jnp.sqrt(gs[0] * gs[0] + gs[1] * gs[1] + gs[2] * gs[2])

    dxx, rem = D(E, exts, 0, 2)
    dxx = _crop(dxx, rem)
    dyy, rem = D(E, exts, 1, 2)
    dyy = _crop(dyy, rem)
    dzz, rem = D(E, exts, 2, 2)
    dzz = _crop(dzz, rem)

    dx, ex1 = D(E, exts, 0, 1)
    dxy, rem = D(dx, ex1, 1, 1)
    dxy = _crop(dxy, rem)
    dxz, rem = D(dx, ex1, 2, 1)
    dxz = _crop(dxz, rem)
    dy, ex2 = D(E, exts, 1, 1)
    dyz, rem = D(dy, ex2, 2, 1)
    dyz = _crop(dyz, rem)

    H = jnp.stack([dxx, dxy, dxz, dyy, dyz, dzz], axis=-1)
    return gm, H


def _features8_block(
    img: jnp.ndarray,
    msk: jnp.ndarray,
    offset: jnp.ndarray,
    sigma: float,
    spacing: Sequence[float],
    truncate: float,
    sharded_axes: Dict[int, str],
) -> Tuple[jnp.ndarray, ...]:
    m = jnp.clip(msk, 0, 1)
    mf = m.astype(img.dtype)

    def smooth(vol):
        for axis in range(3):
            if axis in sharded_axes:
                vol = _smooth_axis_block(
                    vol, axis, sharded_axes[axis], sigma, spacing[axis],
                    truncate,
                )
            else:
                vol = stencil.gaussian_smooth_axis(
                    vol, axis, sigma, spacing[axis], truncate
                )
        return vol

    # smoothed about the global offset, derivatives of the offset-free
    # field — as stencil.centered_normalized_convolution does
    t = smooth((img - offset) * mf) / smooth(mf)

    gm, H = _grad_hessian_block(t, sharded_axes, spacing)
    eig = eigenvalue_features(H)
    inside = m != 0
    zero = jnp.zeros((), img.dtype)
    chans = (t + offset, gm) + tuple(eig[..., k] for k in range(6))
    return tuple(jnp.where(inside, c, zero) for c in chans)


# ---------------------------------------------------------------------------
# public sharded ops
# ---------------------------------------------------------------------------

def _sharded_axis_map(mesh: Mesh) -> Dict[int, str]:
    return {i: name for i, name in enumerate(mesh.axis_names)}


@functools.lru_cache(maxsize=256)
def _features8_fn(mesh: Mesh, sigma: float, spacing, truncate: float):
    """Cached jitted shard_map per (mesh, scale): rebuilding
    the wrapper per call retraces and recompiles the program per
    invocation, which multi-image and multi-scale runs cannot afford."""
    pspec = volume_pspec(mesh)
    block = functools.partial(
        _features8_block,
        sigma=sigma, spacing=spacing, truncate=truncate,
        sharded_axes=_sharded_axis_map(mesh),
    )
    per_block = shard_map(
        block,
        mesh=mesh,
        in_specs=(pspec, pspec, P()),
        out_specs=(pspec,) * 8,
        # the body's collectives are placed by hand; skip the
        # varying-manual-axes check
        check_vma=False,
    )
    # the offset is the GLOBAL rounded image mean, so every shard smooths
    # about the same value as the single-device op
    return jax.jit(lambda img, msk: per_block(
        img, msk, stencil.smoothing_offset(img)))


def sharded_features8(
    image: jax.Array,
    mask: jax.Array,
    sigma: float,
    mesh: Mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
    stack: bool = True,
) -> jax.Array:
    """features8 over a block-sharded volume. Returns (X, Y, Z, 8) sharded
    like the input (stack=True), or a tuple of 8 sharded (X, Y, Z) arrays
    (stack=False — no channel-last relayout; preferred when consumers read
    channels independently, e.g. the histogram pipelines)."""
    fn = _features8_fn(
        mesh, float(sigma), tuple(float(v) for v in spacing), float(truncate),
    )
    out = fn(image, mask)
    if stack:
        return jnp.stack(out, axis=-1)
    return out


@functools.lru_cache(maxsize=64)
def _hessian_eig_fn(mesh: Mesh, spc):
    """Cached jitted shard_map (see _features8_fn)."""
    pspec = volume_pspec(mesh)
    saxes = _sharded_axis_map(mesh)

    def block(img):
        _, H = _grad_hessian_block(img, saxes, spc)
        e = eigenvalue_features(H)
        return tuple(e[..., k] for k in range(6))

    return jax.jit(shard_map(block, mesh=mesh, in_specs=(pspec,),
                             out_specs=(pspec,) * 6, check_vma=False))


def sharded_hessian_eig(
    image: jax.Array,
    mesh: Mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    stack: bool = True,
) -> jax.Array:
    """Hessian -> 6 eigen features of a sharded raw volume: the scaling
    benchmark path (BASELINE.md configs). Returns (X, Y, Z, 6) when
    stack=True, else a tuple of 6 sharded (X, Y, Z) arrays (no
    channel-last copy)."""
    fn = _hessian_eig_fn(mesh, tuple(float(v) for v in spacing))
    out = fn(image)
    if stack:
        return jnp.stack(out, axis=-1)
    return out


def features8_sharded_auto(
    image,
    mask,
    sigma: float,
    mesh: Mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> jax.Array:
    """sharded_features8 for arbitrary volume sizes: edge-pads to the mesh
    grid (exactly composing with ZeroFluxNeumann — see pad_to_mesh), runs
    the sharded op, crops back. Returns the unsharded-shape result."""
    from ife_tpu.parallel.mesh import crop_from_mesh, pad_to_mesh, shard_volume

    img_p, orig = pad_to_mesh(jnp.asarray(image), mesh)
    msk_p, _ = pad_to_mesh(jnp.asarray(mask), mesh)
    out = sharded_features8(
        shard_volume(img_p, mesh), shard_volume(msk_p, mesh),
        sigma, mesh, spacing, truncate,
    )
    return crop_from_mesh(out, orig)


def sharded_multiscale_features(
    image: jax.Array,
    mask: jax.Array,
    sigmas: Sequence[float],
    mesh: Mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    truncate: float = 4.5,
) -> jax.Array:
    """Stacked scales, (X, Y, Z, n_scales, 8), computed fully on-mesh."""
    per = [
        sharded_features8(image, mask, float(s), mesh, spacing, truncate)
        for s in sigmas
    ]
    return jnp.stack(per, axis=-2)
