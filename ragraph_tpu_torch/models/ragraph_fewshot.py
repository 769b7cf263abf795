"""Few-shot RAGraph task models at the node and graph level (counterpart of
``ragraph_tpu/models/ragraph_fewshot.py``).

The two-layer encoder is split: ``encode`` (layer 1, frozen: it runs
without gradients) gives the retrieval keys, ``decode`` (the layers after
it) is trained. Class prototypes are the per-class means of the support
set's full-encoder logits, recomputed with gradients in every step (at the
graph level the support nodes are first averaged per support graph).

A query node's retrieval takes the structure branch of
:func:`ragraph_tpu_torch.rag.library.retrieve`: the library's
configuration (:func:`fewshot_library_config`) weights the position-code
similarity by 0.001 beside the semantic one, and the forward hands it the
query graph's position codes. The retrieved rows' labels map through the
prototypes (``mean(protos[argmax(rag_labels)])``); that is the whole output
without ``finetune``. With it the output fuses a decode of
``(1-rw)·khop(emb) + rw·Σ rag_emb`` with those label logits:

    logits = (1-lw)·decode(hidden) + lw·mean(protos[argmax(rag_labels)])

and classes are scored by cosine to the prototypes.

The graph level averages each graph's node logits. Where the JAX package
``vmap``s one retrieval per graph, :meth:`RAGraphFewshot.forward_graph`
makes one ``retrieve`` call for all ``B·N`` node rows of the stacked batch:
each query row is scored on its own, and each graph's position codes are
computed against its own anchors.

Random values can be passed in: the position anchors (``anchors``) and the
noise rows (``noise_idx``); otherwise they are drawn from the caller's
``torch.Generator``. Without either, the anchors come from a generator
seeded 0 in each call, so that evaluation is deterministic.
"""

from __future__ import annotations

import dataclasses

import torch

from ragraph_tpu_torch.convert import complete_preprompt_state
from ragraph_tpu_torch.core.graph import DenseGraph
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.preprompt import PrePrompt
from ragraph_tpu_torch.ops.propagation import aggregate_k_hop_dense
from ragraph_tpu_torch.ops.shortest_path import position_aware_codes
from ragraph_tpu_torch.rag.fewshot import (fewshot_mean_logits,
                                           fewshot_predict_labels,
                                           fewshot_predict_logits)
from ragraph_tpu_torch.rag.library import (LibraryConfig, ToyGraphLibrary,
                                           build_library, library_init,
                                           retrieve)

# Per-dataset (retrieve_weight, label_weight) of the reference's fewshot
# models; other datasets take (0.5, 0.5).
FEWSHOT_NODE_WEIGHTS = {"ENZYMES": (0.5, 0.5), "PROTEINS": (0.3, 0.8)}
FEWSHOT_GRAPH_WEIGHTS = {"ENZYMES": (0.3, 0.8), "PROTEINS": (0.5, 0.5),
                         "COX2": (0.3, 0.6), "BZR": (0.1, 0.5)}


def fewshot_library_config(retrieve_num: int = 5,
                           **overrides) -> LibraryConfig:
    """The fewshot library: node-level entries with inverse sampling,
    three augmented copies and position codes, retrieved by 0.001 x
    structure + 0.999 x semantic similarity."""
    defaults = dict(
        level="node", num_inverse_sample=10, num_augment_scale=3,
        retrieve_num=retrieve_num, noise_retrieve_num=1, noise_mode="rows",
        use_positions=True, num_anchors=10, dis_q=10,
        structure_weight=0.001, semantic_weight=0.999, toy_graph_hop=2,
    )
    defaults.update(overrides)
    return LibraryConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class RAGraphFewshotConfig:
    """Hyperparameters (the JAX package's defaults)."""

    emb_size: int = 256
    num_class: int = 3
    level: str = "node"              # "node" | "graph"
    retrieve_weight: float = 0.5
    label_weight: float = 0.5
    query_graph_hop: int = 3         # 1 for the graph level
    finetune: bool = True
    noise_finetune: bool = False
    encoder_layers: int = 2          # the encode/decode split needs >= 2
    encoder_dropout: float = 0.3
    library: LibraryConfig = dataclasses.field(
        default_factory=fewshot_library_config)


@dataclasses.dataclass
class FewshotSupportSet:
    """The k-shot support set.

    Node level: ``features (S, F)``, ``adj (S, S)`` and ``labels (S,)``
    per support node, ``graph_ids`` None. Graph level: ``features`` and
    ``adj`` stack the support graphs' nodes block-diagonally, ``labels
    (G,)`` holds one class per support graph, and ``graph_ids (S,)`` maps
    each support node to its graph.
    """

    features: torch.Tensor
    adj: torch.Tensor
    labels: torch.Tensor
    graph_ids: torch.Tensor | None = None

    def to(self, device) -> "FewshotSupportSet":
        return FewshotSupportSet(
            self.features.to(device), self.adj.to(device),
            self.labels.to(device),
            None if self.graph_ids is None else self.graph_ids.to(device))


@dataclasses.dataclass
class RAGraphFewshotState:
    encoder: PrePrompt
    library: ToyGraphLibrary
    support: FewshotSupportSet

    def parameters(self):
        """The finetuned parameters: the encoder's GCN stack."""
        return list(self.encoder.gcn.parameters())


class RAGraphFewshot:
    """The modules and step functions of the fewshot task, on ``device``
    (the card by default; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, cfg: RAGraphFewshotConfig, feature_dim: int,
                 device: str | torch.device = "cuda"):
        if cfg.encoder_layers < 2:
            raise ValueError("the fewshot encoder needs an encode/decode "
                             "split: encoder_layers >= 2")
        self.cfg = cfg
        self.feature_dim = feature_dim
        self.device = resolve_device(device)

    def init_state(self, generator: torch.Generator | None,
                   support: FewshotSupportSet,
                   encoder_state: dict | None = None,
                   library_capacity: int = 4096) -> RAGraphFewshotState:
        """An empty library, the support set on the device, and the encoder
        from ``encoder_state`` (a ``state_dict``; entries it lacks keep
        their defaults) or drawn from ``generator`` (a CPU generator)."""
        cfg = self.cfg
        encoder = PrePrompt(self.feature_dim, hidden=cfg.emb_size,
                            num_layers=cfg.encoder_layers,
                            dropout=cfg.encoder_dropout, generator=generator)
        if encoder_state is not None:
            encoder.load_state_dict(
                complete_preprompt_state(encoder_state, encoder))
        lib = library_init(library_capacity, cfg.emb_size, cfg.num_class,
                           num_anchors=cfg.library.num_anchors,
                           device=self.device)
        return RAGraphFewshotState(encoder=encoder.to(self.device),
                                   library=lib,
                                   support=support.to(self.device))

    # -- encoder splits ----------------------------------------------------

    @staticmethod
    def _encode(state: RAGraphFewshotState, features, adj, node_mask=None):
        """Layer-1 embeddings, frozen."""
        with torch.no_grad():
            return state.encoder.encode(features, adj, node_mask)

    def prototypes(self, state: RAGraphFewshotState) -> torch.Tensor:
        """Class-prototype logits ``(C, H)`` of the support set, with
        gradients; at the graph level the support nodes are averaged per
        support graph first."""
        sup = state.support
        logits = state.encoder.inference(sup.features, sup.adj)
        if sup.graph_ids is not None:
            logits = fewshot_mean_logits(logits, sup.graph_ids,
                                         sup.labels.shape[0])
        return fewshot_mean_logits(logits, sup.labels, self.cfg.num_class)

    # -- library -----------------------------------------------------------

    def build_library(self, state: RAGraphFewshotState, stacked_batches,
                      generator: torch.Generator | None = None,
                      draws_per_batch=None) -> RAGraphFewshotState:
        """Append entries for each stacked batch, keyed by the frozen
        layer 1; repeated calls grow the store."""
        def encode(features, adj, node_mask=None):
            return self._encode(state, features, adj, node_mask)

        lib = build_library(state.library, encode, stacked_batches,
                            self.cfg.library, generator, draws_per_batch)
        return dataclasses.replace(state, library=lib)

    # -- forward -----------------------------------------------------------

    def _fuse(self, state: RAGraphFewshotState, protos, features, adj,
              node_mask, *, training: bool, generator, anchors, noise_idx):
        """Per-node ``H``-dim label logits of one graph ``(N, ...)`` or a
        stack of graphs ``(B, N, ...)``, with one ``retrieve`` for all of
        their rows."""
        cfg, lcfg = self.cfg, self.cfg.library
        emb = self._encode(state, features, adj, node_mask)    # (.., N, E)
        rows = emb.reshape(-1, emb.shape[-1])

        search_positions = None
        if lcfg.use_positions and lcfg.structure_weight != 0.0:
            gen = generator
            if anchors is None and gen is None:
                gen = torch.Generator(emb.device).manual_seed(0)
            search_positions = position_aware_codes(
                adj, node_mask, num_anchors=lcfg.num_anchors,
                dis_q=lcfg.dis_q, anchors=anchors, generator=gen)
            search_positions = search_positions.reshape(rows.shape[0], -1)
        rag_emb, rag_labels = retrieve(
            state.library, rows, lcfg,
            add_noise=training and cfg.noise_finetune, generator=generator,
            search_positions=search_positions, noise_idx=noise_idx)

        rag_idx = rag_labels.argmax(dim=-1)                    # (Q, K)
        rag_logits = protos[rag_idx].mean(dim=1) \
            .reshape(*emb.shape[:-1], protos.shape[-1])
        if not cfg.finetune:
            return rag_logits

        rag_embedding = rag_emb.sum(dim=1).reshape(emb.shape)
        query = aggregate_k_hop_dense(adj, emb, cfg.query_graph_hop)
        hidden = (1.0 - cfg.retrieve_weight) * query \
            + cfg.retrieve_weight * rag_embedding
        decoded = state.encoder.decode(hidden, adj, node_mask)
        return (1.0 - cfg.label_weight) * decoded \
            + cfg.label_weight * rag_logits

    def forward_node(self, state: RAGraphFewshotState, graph: DenseGraph, *,
                     training: bool = False,
                     generator: torch.Generator | None = None,
                     anchors: torch.Tensor | None = None,
                     noise_idx: torch.Tensor | None = None,
                     protos: torch.Tensor | None = None) -> torch.Tensor:
        """Node logits ``(N, H)`` over a block-diagonal batch. ``anchors
        (num_anchors,)`` index the batch's nodes; ``noise_idx (N,
        noise_retrieve_num)`` the library's rows. ``protos``: the
        prototypes, when the caller has them already."""
        if protos is None:
            protos = self.prototypes(state)
        return self._fuse(state, protos, graph.features, graph.adj,
                          graph.node_mask, training=training,
                          generator=generator, anchors=anchors,
                          noise_idx=noise_idx)

    def forward_graph(self, state: RAGraphFewshotState, batch: dict, *,
                      training: bool = False,
                      generator: torch.Generator | None = None,
                      anchors: torch.Tensor | None = None,
                      noise_idx: torch.Tensor | None = None,
                      protos: torch.Tensor | None = None) -> torch.Tensor:
        """Graph logits ``(B, H)``: the mean of each graph's node logits
        over a stacked batch. ``anchors (B, num_anchors)`` index each
        graph's nodes; ``noise_idx (B * N, noise_retrieve_num)``."""
        if protos is None:
            protos = self.prototypes(state)
        node_logits = self._fuse(state, protos, batch["features"],
                                 batch["adj"], batch["node_mask"],
                                 training=training, generator=generator,
                                 anchors=anchors, noise_idx=noise_idx)
        m = batch["node_mask"].to(node_logits.dtype)[..., None]
        return (node_logits * m).sum(dim=1) \
            / torch.clamp_min(m.sum(dim=1), 1.0)

    # -- training ----------------------------------------------------------

    def loss_node(self, state: RAGraphFewshotState, graph: DenseGraph,
                  generator: torch.Generator | None = None,
                  **draws) -> torch.Tensor:
        """Masked cross entropy over the cosine-to-prototype scores;
        ``draws`` (``anchors``, ``noise_idx``) go to :meth:`forward_node`."""
        protos = self.prototypes(state)
        logits = self.forward_node(state, graph, training=True,
                                   generator=generator, protos=protos,
                                   **draws)
        logp = torch.log_softmax(fewshot_predict_logits(protos, logits),
                                 dim=-1)
        per_node = -(graph.labels * logp).sum(dim=-1)
        m = graph.node_mask.to(per_node.dtype)
        return (per_node * m).sum() / torch.clamp_min(m.sum(), 1.0)

    def loss_graph(self, state: RAGraphFewshotState, batch: dict,
                   generator: torch.Generator | None = None,
                   **draws) -> torch.Tensor:
        """Cross entropy over the cosine-to-prototype scores, averaged over
        the batch's real graphs."""
        protos = self.prototypes(state)
        logits = self.forward_graph(state, batch, training=True,
                                    generator=generator, protos=protos,
                                    **draws)
        logp = torch.log_softmax(fewshot_predict_logits(protos, logits),
                                 dim=-1)
        per_graph = -(batch["graph_onehot"] * logp).sum(dim=-1)
        gmask = batch["node_mask"].any(dim=1).to(per_graph.dtype)
        return (per_graph * gmask).sum() / torch.clamp_min(gmask.sum(), 1.0)

    def make_optimizer(self, state: RAGraphFewshotState, lr: float = 1e-4,
                       weight_decay: float = 1e-4) -> torch.optim.Optimizer:
        """AdamW over the encoder's stack, as ``optax.adamw(lr,
        weight_decay=wd)``: betas (0.9, 0.999), eps 1e-8, and the decay
        ``p -= lr·wd·p`` apart from the Adam step."""
        return torch.optim.AdamW(state.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)

    def train_step(self, state: RAGraphFewshotState,
                   optimizer: torch.optim.Optimizer, batch,
                   generator: torch.Generator | None = None,
                   **draws) -> torch.Tensor:
        """One AdamW step of the level's loss, in place; returns the loss
        before the step (a device scalar)."""
        loss_fn = self.loss_node if self.cfg.level == "node" \
            else self.loss_graph
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state, batch, generator, **draws)
        loss.backward()
        optimizer.step()
        return loss.detach()

    # -- evaluation --------------------------------------------------------

    def accuracy_node(self, state: RAGraphFewshotState, graphs) -> float:
        """Nearest-prototype accuracy over the real nodes of an iterable of
        block-diagonal batches; the counts stay on the device until the
        end."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            protos = self.prototypes(state)
            for g in graphs:
                pred = fewshot_predict_labels(
                    protos, self.forward_node(state, g, protos=protos))
                ok = (pred == g.labels.argmax(dim=-1)) & g.node_mask
                correct += ok.sum()
                total += g.node_mask.sum()
        return int(correct) / max(int(total), 1)

    def accuracy_graph(self, state: RAGraphFewshotState, batches) -> float:
        """Nearest-prototype accuracy over the real graphs of an iterable
        of stacked batches."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            protos = self.prototypes(state)
            for b in batches:
                pred = fewshot_predict_labels(
                    protos, self.forward_graph(state, b, protos=protos))
                gmask = b["node_mask"].any(dim=1)
                ok = (pred == b["graph_onehot"].argmax(dim=-1)) & gmask
                correct += ok.sum()
                total += gmask.sum()
        return int(correct) / max(int(total), 1)
