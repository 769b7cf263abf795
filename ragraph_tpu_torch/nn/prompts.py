"""GraphPrompt-style downstream prompt heads (counterpart of
``ragraph_tpu/nn/prompts.py``).

- :func:`average_emb`: per-class mean embeddings, a segment mean over any
  number of classes, optionally masked;
- :class:`DownstreamPrompt`: a learnable elementwise ``(1, H)`` prompt,
  with ELU in the node variant;
- :class:`WeightedPrompt`: a ``(1, n)`` mixer of ``n`` prompts, initialised
  to 0.9 with the third weight 0.1;
- :class:`WeightedFeature`: ``elu(w0 * a + w1 * b)``, initialised to (1, 0);
- :class:`DownPrompt`: prompted embeddings classified by cosine to class
  centroids, then softmax;
- graph helpers: :func:`sum_pool_by_graph`, :func:`distance_to_center`
  (squared euclidean) and :func:`onehot`.

The modules keep the JAX parameters' names and shapes (``weight``);
:func:`ragraph_tpu_torch.convert.prompt_params_from_jax` carries a JAX
tree over.
"""

from __future__ import annotations

import torch
from torch import nn

from ragraph_tpu_torch.nn.layers import xavier_uniform_
from ragraph_tpu_torch.ops.similarity import l2_normalize


def average_emb(embeddings: torch.Tensor, labels: torch.Tensor,
                num_classes: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-class mean embedding ``(C, H)``; rows that ``mask`` drops count
    for nothing, and a class without rows gets a zero row."""
    w = (mask.to(embeddings.dtype) if mask is not None
         else embeddings.new_ones(embeddings.shape[0]))
    idx = labels.long()
    sums = embeddings.new_zeros((num_classes, embeddings.shape[1])) \
        .index_add(0, idx, embeddings * w[:, None])
    counts = embeddings.new_zeros(num_classes).index_add(0, idx, w)
    return sums / torch.clamp_min(counts, 1.0)[:, None]


class DownstreamPrompt(nn.Module):
    """Elementwise prompt ``act(weight * x)``; ``weight (1, hidden)`` is
    Glorot-uniform from ``generator``."""

    def __init__(self, hidden: int, use_act: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_act = use_act     # the node variant applies ELU
        self.weight = nn.Parameter(torch.empty(1, hidden))
        xavier_uniform_(self.weight, generator)

    def forward(self, x):
        out = self.weight * x
        return torch.nn.functional.elu(out) if self.use_act else out


class WeightedPrompt(nn.Module):
    """``weight (1, n) @ prompts (n, H)``, ``weight`` initialised to 0.9
    with its third entry 0.1 (when there are three or more)."""

    def __init__(self, num_prompts: int = 3):
        super().__init__()
        base = torch.full((1, num_prompts), 0.9)
        if num_prompts >= 3:
            base[0, 2] = 0.1
        self.weight = nn.Parameter(base)

    def forward(self, prompts):
        return self.weight @ prompts


class WeightedFeature(nn.Module):
    """``elu(w0 * a + w1 * b)`` with ``weight = [[1, 0]]`` at the start."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor([[1.0, 0.0]]))

    def forward(self, a, b):
        return torch.nn.functional.elu(self.weight[0, 0] * a
                                       + self.weight[0, 1] * b)


class DownPrompt(nn.Module):
    """Downstream head: prompted embeddings, cosine to the class centroids,
    softmax over the classes. ``forward(seq, centroids)``; the centroids
    are :func:`average_emb` of the prompted support embeddings."""

    def __init__(self, hidden: int, num_classes: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.down = DownstreamPrompt(hidden, generator=generator)

    def prompt_features(self, seq):
        return self.down(seq)

    def forward(self, seq, centroids):
        sims = l2_normalize(self.down(seq)) @ l2_normalize(centroids).T
        return torch.softmax(sims, dim=1)


def sum_pool_by_graph(node_feats: torch.Tensor, graph_ids: torch.Tensor,
                      num_graphs: int,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-graph sum of the node rows ``mask`` keeps."""
    if mask is not None:
        node_feats = node_feats * mask.to(node_feats.dtype)[:, None]
    return node_feats.new_zeros((num_graphs, node_feats.shape[1])) \
        .index_add(0, graph_ids.long(), node_feats)


def distance_to_center(x: torch.Tensor,
                       centers: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances ``(N, K)``."""
    xx = (x * x).sum(dim=1, keepdim=True)
    cc = (centers * centers).sum(dim=1)[None, :]
    return xx + cc - 2.0 * (x @ centers.T)


def onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot rows."""
    return torch.nn.functional.one_hot(labels.long(),
                                       num_classes).to(torch.float32)
