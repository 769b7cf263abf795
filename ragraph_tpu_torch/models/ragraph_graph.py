"""RAGraph graph-classification task model (counterpart of
``ragraph_tpu/models/ragraph_graph.py``).

A graph's query key is its masked mean node embedding; the library holds one
mean-pooled entry per resource graph with its one-hot graph label
(:func:`graph_library_config`); the fusion weights are per dataset
(:data:`GRAPH_FUSION_WEIGHTS`); the query propagates one hop; noise is
additive Gaussian on the retrieved values.

The model runs on stacked batches (``features (B, N, F)``, ``adj (B, N,
N)``, ``node_mask (B, N)``, ``graph_onehot (B, C)``): the encoder takes the
leading batch dimension directly where the JAX package ``vmap``s it. The
state, the library build and the training step are the node model's
(:class:`ragraph_tpu_torch.models.ragraph_node.RAGraphNode`).
"""

from __future__ import annotations

import dataclasses

import torch

from ragraph_tpu_torch.models.ragraph_node import (RAGraphNode,
                                                   RAGraphNodeState)
from ragraph_tpu_torch.ops.propagation import aggregate_k_hop_dense
from ragraph_tpu_torch.rag.library import LibraryConfig, retrieve

# Per-dataset (retrieve_weight, label_weight) of the reference RAGraph
# graph model; other datasets take (0.3, 0.3).
GRAPH_FUSION_WEIGHTS = {
    "BZR": (0.1, 0.5),
    "COX2": (0.3, 0.6),
    "PROTEINS": (0.5, 0.5),
    "ENZYMES": (0.3, 0.8),
}


def graph_library_config(num_class: int, **overrides) -> LibraryConfig:
    """The graph variant's library: no inverse sampling, no augmented
    copies, no positions, no value propagation, Gaussian noise (std 0.01)
    and ``retrieve_num = min(3, num_class + 1)``."""
    defaults = dict(
        level="graph", num_inverse_sample=0, num_augment_scale=0,
        retrieve_num=min(3, num_class + 1), noise_retrieve_num=1,
        noise_mode="gaussian", noise_std=0.01, toy_graph_hop=0,
        use_positions=False,
    )
    defaults.update(overrides)
    return LibraryConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class RAGraphGraphConfig:
    """Hyperparameters (the JAX package's defaults)."""

    emb_size: int = 256
    num_class: int = 3
    retrieve_weight: float = 0.3
    label_weight: float = 0.3
    query_graph_hop: int = 1
    finetune: bool = True
    noise_finetune: bool = False
    encoder_layers: int = 1
    encoder_dropout: float = 0.3
    library: LibraryConfig = dataclasses.field(
        default_factory=lambda: graph_library_config(3))


def _graph_mask(batch: dict) -> torch.Tensor:
    """``(B,)``: the graphs of the batch that are not padding."""
    return batch["node_mask"].any(dim=1)


class RAGraphGraph(RAGraphNode):
    """Graph-level RAGraph over stacked padded batches, on ``device``."""

    def forward(self, state: RAGraphNodeState, batch: dict, *,
                training: bool = False,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        """Per-graph label "logits" ``(B, C)`` (probabilities, as in the
        reference). Under ``noise_finetune`` in training the retrieved
        values get ``noise_std`` times ``noise`` (standard normals, ``(B,
        2 * retrieve_num, E)``) or normals drawn from ``generator``."""
        cfg = self.cfg
        emb = state.encoder.inference(batch["features"], batch["adj"],
                                      batch["node_mask"])     # (B, N, E)
        m = batch["node_mask"].to(emb.dtype)[:, :, None]
        denom = torch.clamp_min(m.sum(dim=1), 1.0)
        graph_query = (emb * m).sum(dim=1) / denom             # (B, E)

        add_noise = training and cfg.noise_finetune
        rag_emb, rag_labels = retrieve(state.library, graph_query,
                                       cfg.library, add_noise=add_noise,
                                       generator=generator, noise=noise)
        rag_label = rag_labels.mean(dim=1)                     # (B, C)
        if not cfg.finetune:
            return rag_label

        rag_embedding = rag_emb.sum(dim=1)                     # (B, E)
        khop = aggregate_k_hop_dense(batch["adj"], emb, cfg.query_graph_hop)
        query = (khop * m).sum(dim=1) / denom                  # (B, E)
        hidden = (1.0 - cfg.retrieve_weight) * query \
            + cfg.retrieve_weight * rag_embedding
        decoded = torch.softmax(state.decoder(hidden), dim=-1)
        return (1.0 - cfg.label_weight) * decoded \
            + cfg.label_weight * rag_label

    def loss_terms(self, state: RAGraphNodeState, batch: dict,
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None):
        """Per-graph soft-target cross entropy over the ``log_softmax`` of
        the probability "logits", and the real-graph mask, ``(B,)`` each."""
        logits = self.forward(state, batch, training=True,
                              generator=generator, noise=noise)
        logp = torch.log_softmax(logits, dim=-1)
        per_graph = -(batch["graph_onehot"] * logp).sum(dim=-1)
        return per_graph, _graph_mask(batch).to(per_graph.dtype)

    def accuracy(self, state: RAGraphNodeState, batches) -> float:
        """Argmax accuracy over the real graphs of an iterable of stacked
        batches; the counts stay on the device until the end."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for b in batches:
                logits = self.forward(state, b)
                gmask = _graph_mask(b)
                ok = (logits.argmax(dim=-1)
                      == b["graph_onehot"].argmax(dim=-1)) & gmask
                correct += ok.sum()
                total += gmask.sum()
        return int(correct) / max(int(total), 1)
