"""Operation and byte counts of the kernels' work, from the cell's shapes,
with no padding: what these inputs need, each input byte read once and
each output byte written once.

- Retrieval (kernel C and, past k = 128, the selection family): the score
  product of every query with every library row, ``2 Q R E`` operations;
  the bf16 queries and keys read once and the ``(Q, k)`` scores and
  indices written once.
- Propagation, one call of kernel A (``csr_gather_scale_segsum``): ``2 N_e
  D`` operations (a multiply and an add per edge and column); the bf16
  table, the f32 weights, the int32 ids and the CSR bounds read once, the
  f32 output written once. One call of kernel B (``csr_segment_sum``):
  the f32 messages and the bounds read once, the output written once.
"""

from __future__ import annotations

# the kernels' names in a device trace, by layer
RETRIEVAL_KERNELS = ("topk_partial_kernel", "topk_merge_kernel",
                     "select_topk_kernel", "bucket_max_kernel")
PROPAGATION_KERNELS = ("walk_kernel", "csr_rows_kernel", "scan_kernel")


def retrieval_flops(q: int, r: int, e: int) -> float:
    return 2.0 * q * r * e


def retrieval_bytes(q: int, r: int, e: int, k: int) -> float:
    return 2.0 * q * e + 2.0 * r * e + 8.0 * q * k


def propagation_a_flops(n_edges: int, d: int) -> float:
    return 2.0 * n_edges * d


def propagation_a_bytes(n_nodes: int, n_edges: int, d: int) -> float:
    return (2.0 * n_nodes * d + 4.0 * n_edges + 4.0 * n_edges
            + 4.0 * (n_nodes + 1) + 4.0 * n_nodes * d)


def propagation_b_bytes(n_nodes: int, n_edges: int, d: int) -> float:
    return 4.0 * n_edges * d + 4.0 * (n_nodes + 1) + 4.0 * n_nodes * d


def retrievals_per_unit(view) -> float:
    """Whole retrievals (every node against the library) per step or
    evaluation: kernel C's launches over the chunks of one retrieval."""
    s = view.shapes
    chunks = -(-s["num_nodes"] // max(s["rag_chunk"], 1))
    return view.counters.get("fused_cosine_topk", 0) / chunks \
        / max(view.units, 1)


def a_calls_per_unit(view) -> float:
    return view.counters.get("csr_gather_scale_segsum", 0) \
        / max(view.units, 1)


def b_calls_per_unit(view) -> float:
    return view.counters.get("csr_segment_sum", 0) / max(view.units, 1)
