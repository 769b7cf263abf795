"""The dynamic-graph baselines ROLAND and EvolveGCN-H/-O, and their crosses
with the plugins (counterpart of ``ragraph_tpu/models/edge/dynamic.py``).

- ``Roland``: after each propagation layer a GRU fuses the output with the
  same layer of the *meta model* (a plain propagation of the stage's
  starting params, detached); after each stage the meta state is the EMA
  ``0.1 · current + 0.9 · meta`` (:func:`ema_merge`).
- ``EvolveGCNH``: one GRU step of the table against the previous stage's
  embeddings, then plain LightGCN propagation.
- ``EvolveGCNO``: the GRU's self-evolution ``h' = GRU(h, h)`` of the table
  before propagation.
- :func:`make_dynamic` crosses a plugin loss with one of the three.

None of them has time encoding or a gate. :func:`gru_cell` is
``torch.nn.GRUCell``'s step as a function of a params dict (``w_ih``,
``w_hh``, ``b_ih``, ``b_hh``; gate order reset, update, new), so the GRU's
weights live in the model's params dict under ``gru`` beside the tables.
Under a profiler recording each GRU step is span ``roland.gru`` and counts
its rows (``roland.gru_rows``).
"""

from __future__ import annotations

import math

import torch

from ragraph_tpu_torch.models.edge.base import bpr_loss, reg_loss_emb
from ragraph_tpu_torch.models.edge.ragraph_edge import TemporalLightGCN
from ragraph_tpu_torch.train.profiling import count, span


def gru_cell_init(generator: torch.Generator, size: int,
                  device=None) -> dict:
    """GRUCell-shaped params, uniform in ``±1/sqrt(size)`` as torch
    initialises them: stacked ``(3H, H)`` weights and ``(3H,)`` biases."""
    bound = 1.0 / math.sqrt(size)
    device = device if device is not None else generator.device

    def u(shape):
        return (2.0 * torch.rand(shape, generator=generator, device=device)
                - 1.0) * bound
    return {"w_ih": u((3 * size, size)), "w_hh": u((3 * size, size)),
            "b_ih": u((3 * size,)), "b_hh": u((3 * size,))}


def gru_cell(params: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step, gates in torch's order (reset, update, new):
    ``n = tanh(W_n x + b_in + r ∘ (U_n h + b_hn))``."""
    count("roland.gru_rows", x.shape[0])
    with span("roland.gru"):
        gi = x @ params["w_ih"].T + params["b_ih"]
        gh = h @ params["w_hh"].T + params["b_hh"]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1 - z) * n + z * h


def ema_merge(current: dict, meta: dict, meta_weight: float = 0.9) -> dict:
    """ROLAND's meta update ``(1 - w) · current + w · meta``, per tensor,
    through nested dicts."""
    return {k: ema_merge(v, meta[k], meta_weight) if isinstance(v, dict)
            else (1 - meta_weight) * v + meta_weight * meta[k]
            for k, v in current.items()}


def _drop_gate(params: dict) -> dict:
    params.pop("gating_weight", None)
    params.pop("gating_bias", None)
    return params


def make_dynamic(plugin_cls, mode: str):
    """Cross a plugin loss with a dynamic embedding evolution: ``"roland"``
    (a GRU per layer against the meta model's layers), ``"evolvegcn_h"``
    (a GRU against the previous stage's embeddings) or ``"evolvegcn_o"``
    (the GRU's self-evolution). The crosses propagate without time
    encoding and without a gate, and SimGCL's keeps its BPR term."""
    if mode not in ("roland", "evolvegcn_h", "evolvegcn_o"):
        raise ValueError(f"unknown dynamic mode {mode!r}")

    class Crossed(plugin_cls):
        use_time = False
        bpr_in_cal_loss = True
        _computing_meta = False

        def __init__(self, cfg, graph, phase: str = "finetune", mesh=None):
            super().__init__(cfg, graph, phase, mesh=mesh)
            self.meta_layers = None
            self.last_emb = None

        def _gate(self, params, all_emb, generator, training=False):
            return all_emb

        def init_params(self, generator, pretrained_tables=None):
            params = _drop_gate(super().init_params(generator,
                                                    pretrained_tables))
            params["gru"] = gru_cell_init(generator, self.cfg.emb_size,
                                          self.graph.device)
            return params

        def set_meta_layers(self, meta_layers):
            self.meta_layers = [m.detach() for m in meta_layers]

        def propagated_plain(self, params, return_layers=True):
            """The layers with ROLAND's fusion bypassed: the meta model's
            own plain propagation."""
            self._computing_meta = True
            try:
                return self._propagated(params, None, False, None,
                                        return_layers=return_layers)
            finally:
                self._computing_meta = False

        def set_last_emb(self, last_emb):
            self.last_emb = last_emb.detach()

        def _evolve(self, params, all_emb):
            if mode == "evolvegcn_o":
                return gru_cell(params["gru"], all_emb, all_emb)
            if mode == "evolvegcn_h":
                if self.last_emb is None:
                    raise RuntimeError("call set_last_emb first")
                return gru_cell(params["gru"], all_emb, self.last_emb)
            return all_emb

        def _layer_fuse(self, params, h, layer_idx):
            if mode == "roland" and not self._computing_meta:
                if self.meta_layers is None:
                    raise RuntimeError("call set_meta_layers first")
                return gru_cell(params["gru"], h,
                                self.meta_layers[layer_idx + 1])
            return h

    Crossed.__name__ = Crossed.__qualname__ = f"{plugin_cls.__name__}_{mode}"
    return Crossed


class DynamicBase(TemporalLightGCN):
    """The plain LightGCN engine (no time, no gate) of the dynamic models."""

    use_time = False
    use_rag = False
    rows_independent = False

    def _gate(self, params, all_emb, generator, training: bool = False):
        return all_emb

    def init_params(self, generator: torch.Generator,
                    pretrained_tables: tuple | None = None) -> dict:
        params = _drop_gate(super().init_params(generator, pretrained_tables))
        params["gru"] = gru_cell_init(generator, self.cfg.emb_size,
                                      self.graph.device)
        return params

    def _tables(self, params):
        return torch.cat([params["user_embedding"], params["item_embedding"]],
                         dim=0)

    def _plain_layers(self, params, edge_mask, all_emb, graph=None,
                      edge_mask_send=None):
        g = self.graph if graph is None else graph
        weights, w_send, impl = self._edge_weights(g, edge_mask,
                                                   edge_mask_send)
        return self._propagate_layers(g, all_emb, weights, w_send, impl)

    def cal_loss(self, params, batch, generator, graph=None, resources=None,
                 edge_masks=None):
        """BPR and L2 on the model's forward under the step's edge dropout
        (``edge_masks``, or drawn from ``generator``)."""
        g = self.graph if graph is None else graph
        users, pos_items, neg_items = (t.long() for t in batch)
        mask, mask_send = (edge_masks if edge_masks is not None
                           else self._drop_masks(
                               generator, g, 1.0 - self.cfg.edge_dropout))
        user_emb, item_emb = self.forward(params, edge_mask=mask,
                                          edge_mask_send=mask_send, graph=g)
        rec = bpr_loss(user_emb[users], item_emb[pos_items],
                       item_emb[neg_items])
        reg = self.cfg.weight_decay * reg_loss_emb(
            params["user_embedding"], params["item_embedding"], users,
            pos_items, neg_items)
        return rec + reg, {"rec_loss": rec, "reg_loss": reg}


class Roland(DynamicBase):
    """ROLAND: a GRU per layer against the meta model's layers."""

    def __init__(self, cfg, graph, phase: str = "finetune", mesh=None):
        super().__init__(cfg, graph, phase, mesh=mesh)
        self.meta_layers = None     # [(N, E)] of the meta model

    def set_meta_layers(self, meta_layers):
        """The meta model's layers (:meth:`forward_lgn`), detached."""
        self.meta_layers = [m.detach() for m in meta_layers]

    def forward_lgn(self, params, *, edge_mask=None, edge_mask_send=None,
                    return_layers=False, graph=None, **_):
        """The plain propagation of the tables, the meta model's forward."""
        g = self.graph if graph is None else graph
        layers = self._plain_layers(params, edge_mask, self._tables(params),
                                    graph=g, edge_mask_send=edge_mask_send)
        if return_layers:
            return layers
        res = sum(layers)
        return res[: g.num_users], res[g.num_users:]

    def forward(self, params, *, generator=None, training=False,
                edge_mask=None, edge_mask_send=None, graph=None, **_):
        if self.meta_layers is None:
            raise RuntimeError("call set_meta_layers first")
        g = self.graph if graph is None else graph
        weights, w_send, impl = self._edge_weights(g, edge_mask,
                                                   edge_mask_send)
        h = self._tables(params)
        layers = [h]
        for layer in range(self.cfg.num_layers):
            h = self._prop_layer(g, h, weights, w_send, impl)
            h = gru_cell(params["gru"], h, self.meta_layers[layer + 1])
            layers.append(h)
        res = sum(layers)
        return res[: g.num_users], res[g.num_users:]


class EvolveGCNH(DynamicBase):
    """EvolveGCN-H: a GRU step of the table against the previous stage's
    embeddings."""

    def __init__(self, cfg, graph, phase: str = "finetune", mesh=None):
        super().__init__(cfg, graph, phase, mesh=mesh)
        self.last_emb = None        # (N, E) of the previous stage

    def set_last_emb(self, last_emb):
        self.last_emb = last_emb.detach()

    def forward(self, params, *, generator=None, training=False,
                edge_mask=None, edge_mask_send=None, graph=None, **_):
        if self.last_emb is None:
            raise RuntimeError("call set_last_emb first")
        g = self.graph if graph is None else graph
        all_emb = gru_cell(params["gru"], self._tables(params), self.last_emb)
        res = sum(self._plain_layers(params, edge_mask, all_emb, graph=g,
                                     edge_mask_send=edge_mask_send))
        return res[: g.num_users], res[g.num_users:]


class EvolveGCNO(DynamicBase):
    """EvolveGCN-O: the GRU's self-evolution of the table."""

    def forward(self, params, *, generator=None, training=False,
                edge_mask=None, edge_mask_send=None, graph=None, **_):
        g = self.graph if graph is None else graph
        tables = self._tables(params)
        all_emb = gru_cell(params["gru"], tables, tables)
        res = sum(self._plain_layers(params, edge_mask, all_emb, graph=g,
                                     edge_mask_send=edge_mask_send))
        return res[: g.num_users], res[g.num_users:]
