"""The edge (recommendation) model family of the port."""

from ragraph_tpu_torch.models.edge.base import (EdgeModelConfig, bpr_loss,
                                                cal_infonce, edge_drop_mask,
                                                hash_edge_mask,
                                                lightgcn_propagate, nce_loss,
                                                reg_loss_emb,
                                                relative_time_encoding)
from ragraph_tpu_torch.models.edge.dynamic import (EvolveGCNH, EvolveGCNO,
                                                   Roland, ema_merge,
                                                   gru_cell, gru_cell_init,
                                                   make_dynamic)
from ragraph_tpu_torch.models.edge.graphprompt import (GraphPromptEdge,
                                                       make_prompted)
from ragraph_tpu_torch.models.edge.plugins import (LightGCNPlugin,
                                                   MixGCFPlugin, PluginBase,
                                                   SGLPlugin, SimGCLPlugin)
from ragraph_tpu_torch.models.edge.ragraph_edge import (EDGE_DATASET_CONFIGS,
                                                        EdgeGraphArrays,
                                                        GraphPro,
                                                        LightGCNEdge,
                                                        RAGraphEdge,
                                                        TemporalLightGCN,
                                                        edge_config_for)
from ragraph_tpu_torch.models.edge.staged import (StageResult,
                                                  dynamic_stage,
                                                  interpolative_merge,
                                                  staged_dynamic,
                                                  staged_finetune)

__all__ = ["EDGE_DATASET_CONFIGS", "EdgeGraphArrays", "EdgeModelConfig",
           "EvolveGCNH", "EvolveGCNO", "GraphPro", "GraphPromptEdge",
           "LightGCNEdge", "LightGCNPlugin", "MixGCFPlugin", "PluginBase",
           "RAGraphEdge", "Roland", "SGLPlugin", "SimGCLPlugin",
           "StageResult", "TemporalLightGCN", "bpr_loss", "cal_infonce",
           "dynamic_stage", "edge_config_for", "edge_drop_mask", "ema_merge",
           "gru_cell", "gru_cell_init", "hash_edge_mask", "interpolative_merge",
           "lightgcn_propagate", "make_dynamic", "make_prompted", "nce_loss",
           "reg_loss_emb", "relative_time_encoding", "staged_dynamic",
           "staged_finetune"]
