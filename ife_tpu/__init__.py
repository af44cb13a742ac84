"""ife_tpu — dense 3D feature extraction in JAX on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of
``orting/image-feature-extraction`` (C++/ITK): masked Gaussian scale-space
smoothing, finite-difference gradient/Hessian stencils, closed-form symmetric
3x3 per-voxel eigenvalue features, dense-histogram equalization and
bag-of-features assembly — built for device meshes (shard_map + halo
exchange over the device interconnect) rather than ITK's single-node
demand-driven filter DAG.

Index convention: volumes are arrays of shape (X, Y, Z) indexed [x, y, z],
matching the reference's ITK index order (reference:
include/ife/Filters/Hessian3DImageFilter.hxx:23-28 maps direction 0/1/2 to
x/y/z). Spacing/origin are (sx, sy, sz) tuples in physical units.
"""

__version__ = "0.1.0"

from ife_tpu.core.volume import Volume  # noqa: F401
