"""RAGraph node-classification task model (counterpart of
``ragraph_tpu/models/ragraph_node.py``).

``forward(state, graph)``: frozen-encoder embeddings → library retrieval →
fusion:

    hidden = (1-w_r)·khop(query) + w_r·Σ(rag_emb)
    logits = (1-w_l)·softmax(decoder(hidden)) + w_l·mean(rag_labels)

Training-free mode returns ``mean(rag_labels)`` alone.

The state bundles the encoder and decoder modules with the library.
Gradients flow into both encoder and decoder during fine-tuning; the
library's tensors are buffers, and the retrieval runs without gradients on
detached queries, so the encoder is reached through the k-hop query only.
"""

from __future__ import annotations

import dataclasses

import torch

from ragraph_tpu_torch.convert import complete_preprompt_state
from ragraph_tpu_torch.core.graph import DenseGraph
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.preprompt import PrePrompt
from ragraph_tpu_torch.nn.heads import TaskDecoder
from ragraph_tpu_torch.ops.propagation import aggregate_k_hop_dense
from ragraph_tpu_torch.rag.library import (LibraryConfig, ToyGraphLibrary,
                                           build_library, library_init,
                                           retrieve)


@dataclasses.dataclass(frozen=True)
class RAGraphNodeConfig:
    """Hyperparameters (the JAX package's defaults)."""

    emb_size: int = 256
    num_class: int = 3
    retrieve_weight: float = 0.5
    label_weight: float = 0.5
    query_graph_hop: int = 3
    finetune: bool = True
    noise_finetune: bool = False
    encoder_layers: int = 1
    encoder_dropout: float = 0.3
    library: LibraryConfig = dataclasses.field(default_factory=LibraryConfig)


@dataclasses.dataclass
class RAGraphNodeState:
    encoder: PrePrompt
    decoder: TaskDecoder
    library: ToyGraphLibrary

    def parameters(self):
        """The finetuned parameters: the encoder's GCN stack, then the
        decoder (the pretraining heads take no part downstream)."""
        return list(self.encoder.gcn.parameters()) \
            + list(self.decoder.parameters())


class RAGraphNode:
    """The modules and step functions of the node task, on ``device``
    (the card by default; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, cfg: RAGraphNodeConfig, feature_dim: int,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.feature_dim = feature_dim
        self.device = resolve_device(device)

    # -- initialization ----------------------------------------------------

    def init_state(self, generator: torch.Generator | None = None,
                   encoder_state: dict | None = None,
                   library_capacity: int = 4096) -> RAGraphNodeState:
        """A fresh decoder and library, and the encoder from
        ``encoder_state`` (a ``state_dict``, e.g. from
        :func:`ragraph_tpu_torch.convert.preprompt_params_from_jax`; batch
        norm entries it lacks keep their defaults) or
        drawn from ``generator`` (a CPU generator: the parameters are drawn
        on the host and moved)."""
        cfg = self.cfg
        encoder = PrePrompt(self.feature_dim, hidden=cfg.emb_size,
                            num_layers=cfg.encoder_layers,
                            dropout=cfg.encoder_dropout, generator=generator)
        if encoder_state is not None:
            encoder.load_state_dict(
                complete_preprompt_state(encoder_state, encoder))
        decoder = TaskDecoder(cfg.emb_size, cfg.emb_size, cfg.num_class,
                              generator=generator)
        lib = library_init(library_capacity, cfg.emb_size, cfg.num_class,
                           num_anchors=cfg.library.num_anchors,
                           device=self.device)
        return RAGraphNodeState(encoder=encoder.to(self.device),
                                decoder=decoder.to(self.device), library=lib)

    def encoder_fn(self, state: RAGraphNodeState):
        def fn(features, adj, node_mask=None):
            return state.encoder.inference(features, adj, node_mask)
        return fn

    # -- library build -----------------------------------------------------

    def build_library(self, state: RAGraphNodeState, stacked_batches,
                      generator: torch.Generator | None = None,
                      draws_per_batch=None) -> RAGraphNodeState:
        """Append entries for each stacked batch; repeated calls grow the
        store, they never reset it."""
        lib = build_library(state.library, self.encoder_fn(state),
                            stacked_batches, self.cfg.library, generator,
                            draws_per_batch)
        return dataclasses.replace(state, library=lib)

    # -- forward -----------------------------------------------------------

    def forward(self, state: RAGraphNodeState, graph: DenseGraph, *,
                training: bool = False,
                generator: torch.Generator | None = None,
                noise_idx: torch.Tensor | None = None) -> torch.Tensor:
        """Label "logits" ``(N, C)``: probabilities, as in the reference."""
        cfg = self.cfg
        emb = state.encoder.inference(graph.features, graph.adj,
                                      graph.node_mask)
        add_noise = training and cfg.noise_finetune
        rag_emb, rag_labels = retrieve(state.library, emb, cfg.library,
                                       add_noise=add_noise,
                                       generator=generator,
                                       noise_idx=noise_idx)
        rag_label = rag_labels.mean(dim=1)
        if not cfg.finetune:
            return rag_label

        rag_embedding = rag_emb.sum(dim=1)
        query = aggregate_k_hop_dense(graph.adj, emb, cfg.query_graph_hop)
        hidden = (1.0 - cfg.retrieve_weight) * query \
            + cfg.retrieve_weight * rag_embedding
        decoded = torch.softmax(state.decoder(hidden), dim=-1)
        return (1.0 - cfg.label_weight) * decoded \
            + cfg.label_weight * rag_label

    # -- training ----------------------------------------------------------

    def loss_terms(self, state: RAGraphNodeState, graph: DenseGraph,
                   generator: torch.Generator | None = None,
                   noise_idx: torch.Tensor | None = None):
        """The loss's per-node terms and weights, ``(N,)`` each: soft-target
        cross entropy over the ``log_softmax`` of the probability "logits",
        as the reference's ``F.cross_entropy(logits, onehot)``, and the
        node mask. :meth:`loss` is ``Σ terms·w / max(Σ w, 1)``."""
        logits = self.forward(state, graph, training=True,
                              generator=generator, noise_idx=noise_idx)
        logp = torch.log_softmax(logits, dim=-1)
        per_node = -(graph.labels * logp).sum(dim=-1)
        return per_node, graph.node_mask.to(per_node.dtype)

    def loss(self, state: RAGraphNodeState, graph: DenseGraph,
             generator: torch.Generator | None = None, **draws
             ) -> torch.Tensor:
        """The masked mean of :meth:`loss_terms`."""
        per, m = self.loss_terms(state, graph, generator, **draws)
        return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)

    def make_optimizer(self, state: RAGraphNodeState,
                       lr: float = 1e-3) -> torch.optim.Optimizer:
        """Adam over the encoder's and the decoder's parameters (``eps =
        1e-8``, as ``optax.adam``)."""
        return torch.optim.Adam(state.parameters(), lr=lr, eps=1e-8)

    def train_step(self, state: RAGraphNodeState,
                   optimizer: torch.optim.Optimizer, batch,
                   generator: torch.Generator | None = None, mesh=None,
                   **draws) -> torch.Tensor:
        """One Adam step, in place; returns the loss before the step (a
        device scalar). ``draws`` go to :meth:`loss` (``noise_idx``).

        With ``mesh`` every rank runs the forward on the whole batch (the
        GCN reads every row of the block-diagonal graph) and takes the
        loss over its ``dp`` share of the rows; numerators and counts are
        summed apart (:func:`ragraph_tpu_torch.parallel.dp.
        backward_row_share`), and the replicated parameters' gradients
        summed over the mesh."""
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = self.loss(state, batch, generator, **draws)
            loss.backward()
        else:
            from ragraph_tpu_torch.parallel.dp import (backward_row_share,
                                                       sync_grads)
            loss = backward_row_share(
                mesh, *self.loss_terms(state, batch, generator, **draws))
            sync_grads(mesh, state.parameters())
        optimizer.step()
        return loss.detach()

    def accuracy(self, state: RAGraphNodeState, graphs) -> float:
        """Masked argmax accuracy over an iterable of DenseGraph batches;
        the counts stay on the device until the end."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for g in graphs:
                logits = self.forward(state, g)
                ok = (logits.argmax(dim=-1) == g.labels.argmax(dim=-1)) \
                    & g.node_mask
                correct += ok.sum()
                total += g.node_mask.sum()
        return int(correct) / max(int(total), 1)
