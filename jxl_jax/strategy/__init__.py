from jxl_jax.strategy.homogeneity import (  # noqa: F401
    homogeneity_similarity_indices,
    homogeneity_partition,
    laplacian_edge_threshold,
    partition_threshold,
)
