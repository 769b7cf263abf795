"""Retrieval-library helpers of the port."""

from ragraph_tpu_torch.rag.augmentation import (  # noqa: F401
    augment_adj, augment_features, augment_graph, interpolation_node)
from ragraph_tpu_torch.rag.library import (  # noqa: F401
    LibraryConfig, ToyGraphLibrary, build_entries_batch, build_library,
    library_append, library_init, library_reset, retrieve)
from ragraph_tpu_torch.rag.pretrain_aug import (  # noqa: F401
    aug_drop_node, aug_random_edge, aug_random_mask, aug_subgraph,
    draw_view, make_graphcl_views)
from ragraph_tpu_torch.rag.fewshot import (  # noqa: F401
    FewShotBase, fewshot_mean_logits, fewshot_predict_labels,
    fewshot_predict_logits, fewshot_predict_loss)
from ragraph_tpu_torch.rag.ivf import IVFIndex, build_ivf, ivf_search, kmeans  # noqa: F401
