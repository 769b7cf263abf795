"""Tensor ops of the port: similarity, segment sums, retrieval, PageRank."""

from ragraph_tpu_torch.ops.bucket_topk import bucketed_exact_topk, column_topk, row_topk  # noqa: F401
from ragraph_tpu_torch.ops.csr_segment import gather_scale_segsum, segsum_packed2_w, sorted_segment_sum_grad  # noqa: F401
from ragraph_tpu_torch.ops.prefix_sum import sorted_segment_sum, sorted_segment_sum_indptr, streaming_cumsum  # noqa: F401
