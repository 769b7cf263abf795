"""Tensor ops of the port: similarity, propagation, PageRank, shortest
paths, segment sums and retrieval."""

from ragraph_tpu_torch.ops.bucket_topk import bucketed_exact_topk, column_topk, row_topk  # noqa: F401
from ragraph_tpu_torch.ops.csr_segment import gather_scale_segsum, segsum_packed2_w, sorted_segment_sum_grad  # noqa: F401
from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk  # noqa: F401
from ragraph_tpu_torch.ops.pagerank import degree_centrality_dense, inverse_sample_prob_dense, inverse_sample_prob_edges, pagerank_dense, pagerank_edges  # noqa: F401
from ragraph_tpu_torch.ops.prefix_sum import sorted_segment_sum, sorted_segment_sum_indptr, streaming_cumsum  # noqa: F401
from ragraph_tpu_torch.ops.propagation import aggregate_k_hop_dense, aggregate_k_hop_edges  # noqa: F401
from ragraph_tpu_torch.ops.segment import scatter_sum, segment_softmax  # noqa: F401
from ragraph_tpu_torch.ops.shortest_path import all_pairs_shortest_paths, anchor_distances, position_aware_codes  # noqa: F401
from ragraph_tpu_torch.ops.similarity import cosine_similarity, jaccard_similarity, l2_normalize  # noqa: F401
from ragraph_tpu_torch.ops.topk import cosine_topk, quantize_keys_i8, topk_gather  # noqa: F401
