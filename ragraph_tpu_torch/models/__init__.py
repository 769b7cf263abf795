"""Models of the port."""

from ragraph_tpu_torch.models.preprompt import (  # noqa: F401
    PrePrompt, prompt_pretrain_sample, subgraph3_mean)
from ragraph_tpu_torch.models.ragraph_graph import (  # noqa: F401
    GRAPH_FUSION_WEIGHTS, RAGraphGraph, RAGraphGraphConfig,
    graph_library_config)
from ragraph_tpu_torch.models.ragraph_node import (  # noqa: F401
    RAGraphNode, RAGraphNodeConfig, RAGraphNodeState)
from ragraph_tpu_torch.models.ragraph_fewshot import (  # noqa: F401
    FEWSHOT_GRAPH_WEIGHTS, FEWSHOT_NODE_WEIGHTS, FewshotSupportSet,
    RAGraphFewshot, RAGraphFewshotConfig, RAGraphFewshotState,
    fewshot_library_config)
