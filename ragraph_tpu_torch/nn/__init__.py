"""Layers of the port."""

from ragraph_tpu_torch.nn.gating import learned_gate, random_gate  # noqa: F401
from ragraph_tpu_torch.nn.heads import (  # noqa: F401
    DGIHead, GraphCLHead, LogReg, LpHead, TaskDecoder, compare_loss)
from ragraph_tpu_torch.nn.layers import (  # noqa: F401
    BilinearDiscriminator, BilinearDiscriminator2, DenseGAT, DenseGCN,
    PReLU, avg_readout)
from ragraph_tpu_torch.nn.lora import (  # noqa: F401
    LoRAFactors, apply_lora, svd_init)
from ragraph_tpu_torch.nn.stack import GCNStack, MaskedBatchNorm  # noqa: F401
from ragraph_tpu_torch.nn.prompts import (  # noqa: F401
    DownPrompt, DownstreamPrompt, WeightedFeature, WeightedPrompt,
    average_emb, distance_to_center, onehot, sum_pool_by_graph)
