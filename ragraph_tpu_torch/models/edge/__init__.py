"""The edge (recommendation) model family of the port."""

from ragraph_tpu_torch.models.edge.base import (EdgeModelConfig,
                                                lightgcn_propagate,
                                                relative_time_encoding)
from ragraph_tpu_torch.models.edge.staged import (StageResult,
                                                  interpolative_merge,
                                                  staged_dynamic,
                                                  staged_finetune)
from ragraph_tpu_torch.models.edge.ragraph_edge import (EDGE_DATASET_CONFIGS,
                                                        EdgeGraphArrays,
                                                        GraphPro,
                                                        LightGCNEdge,
                                                        RAGraphEdge,
                                                        TemporalLightGCN,
                                                        edge_config_for)

__all__ = ["EDGE_DATASET_CONFIGS", "EdgeGraphArrays", "EdgeModelConfig",
           "GraphPro", "LightGCNEdge", "RAGraphEdge", "StageResult",
           "TemporalLightGCN", "edge_config_for", "interpolative_merge",
           "lightgcn_propagate", "relative_time_encoding", "staged_dynamic",
           "staged_finetune"]
