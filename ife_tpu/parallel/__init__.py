"""Multi-device domain decomposition for dense 3D feature extraction.

The reference is strictly single-node (SURVEY.md §2.4) — every component
here is new design: the voxel grid is block-sharded over a
`jax.sharding.Mesh`, stencils get their neighbor slabs via `ppermute` halo
exchange, and statistics reduce with `psum`.
"""
from ife_tpu.parallel.mesh import (  # noqa: F401
    crop_from_mesh,
    make_mesh,
    pad_to_mesh,
    shard_volume,
    volume_pspec,
)
from ife_tpu.parallel.features import features8_sharded_auto  # noqa: F401
from ife_tpu.parallel.halo import halo_exchange, halo_pad  # noqa: F401
from ife_tpu.parallel.features import (  # noqa: F401
    sharded_features8,
    sharded_hessian_eig,
    sharded_multiscale_features,
)
from ife_tpu.parallel.stats import (  # noqa: F401
    histogram_quantile_edges,
    masked_fine_histogram,
    merge_fine_histograms,
    sharded_feature_fine_histograms,
    sharded_masked_histogram,
)
from ife_tpu.parallel.launcher import (  # noqa: F401
    ShardManifest,
    distributed_init,
    fetch_to_host,
    host_array_to_global,
    is_primary,
)
