"""The prompt-tuning baselines GraphPrompt (multiplicative) and GPF
(additive), and their crosses with the plugins (counterpart of
``ragraph_tpu/models/edge/graphprompt.py``).

``GraphPromptEdge`` is a plain LightGCN (no time, no gate) tuned through one
``(1, E)`` prompt vector, ``prompt_vec``:

- ``graphprompt``: the prompt multiplies the source messages inside every
  aggregation;
- ``gpf``: the prompt is added to the node embeddings once, before
  propagation.

Its layer is the gather, scale, prompt and ``index_add_`` of the messages,
as the JAX model's is an XLA ``segment_sum``: it launches no hand-written
kernel. :func:`make_prompted` puts the same prompt on any plugin engine.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.models.edge.base import (bpr_loss, edge_drop_mask,
                                                reg_loss_emb)
from ragraph_tpu_torch.models.edge.ragraph_edge import (TemporalLightGCN,
                                                        xavier)
from ragraph_tpu_torch.ops.segment import scatter_sum

PROMPT_MODES = ("graphprompt", "gpf")


class GraphPromptEdge(TemporalLightGCN):
    """The GP baseline: plain LightGCN and a learnable prompt vector."""

    use_time = False
    use_rag = False
    rows_independent = False

    def __init__(self, cfg, graph, phase: str = "finetune",
                 prompt_mode: str = "graphprompt", mesh=None):
        if prompt_mode not in PROMPT_MODES:
            raise ValueError(f"prompt_mode must be one of {PROMPT_MODES}, "
                             f"got {prompt_mode!r}")
        super().__init__(cfg, graph, phase, mesh=mesh)
        self.prompt_mode = prompt_mode

    def _gate(self, params, all_emb, generator, training: bool = False):
        return all_emb

    def init_params(self, generator: torch.Generator,
                    pretrained_tables: tuple | None = None) -> dict:
        params = super().init_params(generator, pretrained_tables)
        for k in ("gating_weight", "gating_bias", "user_lora", "item_lora"):
            params.pop(k, None)
        params["prompt_vec"] = xavier((1, self.cfg.emb_size), generator,
                                      self.graph.device)
        return params

    def forward(self, params, *, generator=None, training=False,
                edge_mask=None, graph=None, **_):
        g = self.graph if graph is None else graph
        weights = g.edge_norm
        if edge_mask is not None:
            weights = torch.where(edge_mask, weights, 0.0)
        all_emb = torch.cat([params["user_embedding"],
                             params["item_embedding"]], dim=0)
        prompt = params["prompt_vec"]
        if self.prompt_mode == "gpf":
            all_emb = all_emb + prompt
        senders = g.senders.long()
        layers = [all_emb]
        h = all_emb
        for _ in range(self.cfg.num_layers):
            msgs = h[senders] * weights[:, None]
            if self.prompt_mode == "graphprompt":
                msgs = msgs * prompt
            h = scatter_sum(msgs, g.receivers, g.num_nodes)
            layers.append(h)
        res = sum(layers)
        return res[: g.num_users], res[g.num_users:]

    def cal_loss(self, params, batch, generator, graph=None, resources=None,
                 edge_masks=None):
        """BPR and L2 under a Bernoulli edge dropout in receiver order
        (``edge_masks[0]`` when given)."""
        g = self.graph if graph is None else graph
        users, pos_items, neg_items = (t.long() for t in batch)
        mask = (edge_masks[0] if edge_masks is not None
                else edge_drop_mask(generator, g.num_edges,
                                    1.0 - self.cfg.edge_dropout, g.device))
        user_emb, item_emb = self.forward(params, edge_mask=mask, graph=g)
        rec = bpr_loss(user_emb[users], item_emb[pos_items],
                       item_emb[neg_items])
        reg = self.cfg.weight_decay * reg_loss_emb(
            params["user_embedding"], params["item_embedding"], users,
            pos_items, neg_items)
        return rec + reg, {"rec_loss": rec, "reg_loss": reg}


def make_prompted(plugin_cls, prompt_mode: str = "graphprompt"):
    """Cross a plugin engine with a prompt vector. ``gpf`` offsets the
    tables before propagation; ``graphprompt`` scales each hop's output
    through the ``_hop_prompt`` hook, inside the loop and before SimGCL's
    perturbation: the noise sees ``sign(h · p)`` and propagates on
    prompted. The crosses have no time encoding and no gate, and SimGCL's
    keeps its BPR term."""
    if prompt_mode not in PROMPT_MODES:
        raise ValueError(f"prompt_mode must be one of {PROMPT_MODES}, got "
                         f"{prompt_mode!r}")

    class Prompted(plugin_cls):
        bpr_in_cal_loss = True
        use_time = False

        def _gate(self, params, all_emb, generator, training=False):
            return all_emb

        def init_params(self, generator, pretrained_tables=None):
            params = super().init_params(generator, pretrained_tables)
            params.pop("gating_weight", None)
            params.pop("gating_bias", None)
            params["prompt_vec"] = xavier((1, self.cfg.emb_size), generator,
                                          self.graph.device)
            return params

        def _effective_tables(self, params, generator, training):
            u, it = super()._effective_tables(params, generator, training)
            if prompt_mode == "gpf":
                p = params["prompt_vec"]
                return u + p, it + p
            return u, it

        def _hop_prompt(self, params, h):
            if prompt_mode == "graphprompt":
                return h * params["prompt_vec"]
            return h

    Prompted.__name__ = Prompted.__qualname__ = \
        f"{plugin_cls.__name__}_{prompt_mode}"
    return Prompted
