"""Graph containers of the port."""

from ragraph_tpu_torch.core.graph import (  # noqa: F401
    DenseGraph, EdgeGraph, dense_batch_from_graphs, normalize_adj_dense,
    round_up, row_normalize_adj, segment_mean)
