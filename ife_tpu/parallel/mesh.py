"""Device mesh construction and volume sharding.

Volumes are (X, Y, Z) arrays; we block-shard the leading spatial axes over
a 1D or 2D device mesh (axis names "x", "y"). Z — the minor, contiguous
axis — stays unsharded so every shard's lines stay contiguous in memory.

The reference has no distributed layer at all (SURVEY.md §2.4); the design
here is the standard JAX recipe: build a Mesh, annotate NamedShardings, let
XLA place the collectives (NCCL over NVLink between the cards of a GPU
host). The cards of one host are joined all to all, so the mesh shape
follows the decomposition alone.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("x",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A 1D ("x") or 2D ("x", "y") spatial decomposition mesh.

    For 2D, devices are factored as close to square as possible (a square
    block decomposition minimizes halo surface per device).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]

    if len(axis_names) == 1:
        shape: Tuple[int, ...] = (n_devices,)
    elif len(axis_names) == 2:
        a = int(np.floor(np.sqrt(n_devices)))
        while n_devices % a:
            a -= 1
        shape = (n_devices // a, a)
    else:
        raise ValueError("mesh must be 1D ('x',) or 2D ('x','y')")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def volume_pspec(mesh: Mesh) -> P:
    """PartitionSpec for a (X, Y, Z[, C...]) volume on this mesh: shard the
    leading spatial axes by mesh axis name, replicate everything else."""
    names = mesh.axis_names
    if len(names) == 1:
        return P(names[0])
    return P(names[0], names[1])


def shard_volume(data: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a volume array onto the mesh with block sharding.

    Requires each sharded dim to divide by its mesh extent — use
    `pad_to_mesh` / `crop_from_mesh` for arbitrary sizes. Works across
    hosts: with >1 process (every process holding the same full host
    array) placement goes through `make_array_from_callback`.
    """
    if jax.process_count() > 1:
        from ife_tpu.parallel.launcher import host_array_to_global

        return host_array_to_global(data, mesh)
    return jax.device_put(data, NamedSharding(mesh, volume_pspec(mesh)))


def mesh_dims(mesh: Mesh) -> Tuple[int, int]:
    """(mx, my): device-grid extents along volume axes 0 and 1."""
    dims = mesh.devices.shape
    return dims[0], (dims[1] if len(dims) > 1 else 1)


def pad_to_mesh(data, mesh: Mesh, mode: str = "edge"):
    """Edge-pad the leading spatial dims up to multiples of the mesh grid.

    Edge replication composes exactly with the ops' ZeroFluxNeumann
    boundary (every out-of-volume access clamps to the edge voxel either
    way), so compute-then-`crop_from_mesh` matches the unpadded result.
    Returns (padded_array, original_shape).
    """
    import numpy as _np

    mx, my = mesh_dims(mesh)
    shape = data.shape
    px = (-shape[0]) % mx
    py = (-shape[1]) % my
    if px == 0 and py == 0:
        return data, shape
    pad = [(0, px), (0, py)] + [(0, 0)] * (len(shape) - 2)
    if isinstance(data, _np.ndarray):
        return _np.pad(data, pad, mode=mode), shape
    import jax.numpy as _jnp

    return _jnp.pad(data, pad, mode=mode), shape


def crop_from_mesh(data, original_shape) -> jax.Array:
    """Undo pad_to_mesh on a result (leading dims only)."""
    sl = (slice(0, original_shape[0]), slice(0, original_shape[1]))
    return data[sl]
