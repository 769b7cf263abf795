"""Tensor ops of the port: similarity, segment sums, retrieval, PageRank."""

from ragraph_tpu_torch.ops.bucket_topk import bucketed_exact_topk, column_topk, row_topk  # noqa: F401
