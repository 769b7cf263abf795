"""Host-side data of the port (numpy only)."""

from ragraph_tpu_torch.data.batching import (  # noqa: F401
    compute_pad_nodes, flat_batches, stacked_batches)
from ragraph_tpu_torch.data.edgelist import (  # noqa: F401
    EdgeDataset, load_edge_dataset, merge_rows, parse_edge_file,
    timestamp_to_time_step)
from ragraph_tpu_torch.data.synthetic import (  # noqa: F401
    planted_partition_graph, synthetic_edge_stream, synthetic_tu_dataset)
from ragraph_tpu_torch.data.tu import (  # noqa: F401
    TUDataset, TUGraph, load_tu_dataset)
from ragraph_tpu_torch.data.fewshot_export import (  # noqa: F401
    export_fewshot_graph_split, export_fewshot_splits, load_fewshot_split,
    sample_k_shot_graphs, sample_k_shot_nodes)
from ragraph_tpu_torch.data.planetoid import (  # noqa: F401
    adj_to_bias, load_planetoid, micro_f1, row_normalize_features,
    sample_mask, standardize_data)
