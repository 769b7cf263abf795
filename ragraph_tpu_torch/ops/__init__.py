"""Tensor ops of the port: similarity, segment sums, retrieval, PageRank."""
