from ife_tpu.stats.histogram import (  # noqa: F401
    DenseHistogram,
    histogram_counts,
    batched_histogram_counts,
)
from ife_tpu.stats.equalize import (  # noqa: F401
    determine_edges_for_equalized_histogram,
    edges_from_dense_counts,
)
