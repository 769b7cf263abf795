"""The GraphPro-plugin baselines SGL, SimGCL and MixGCF, and the plugin
LightGCN (counterpart of ``ragraph_tpu/models/edge/plugins.py``).

- :class:`PluginBase` is the temporal gating engine the plugins share: the
  :class:`TemporalLightGCN` engine with a dropout-free learned gate at
  finetune and no time encoding in ``vanilla``. Its per-layer loop
  (:meth:`PluginBase._propagated`) runs :meth:`TemporalLightGCN._prop_layer`
  and leaves hooks for the dynamic crosses (``_evolve``, ``_layer_fuse``)
  and the prompt crosses (``_hop_prompt``).
- ``SGL``: BPR + L2 + λ·InfoNCE between two edge-subsampled views (0.9 of
  the surviving edges each) over the batch's distinct users and items.
- ``SimGCL``: λ·(user + item InfoNCE at temperature 0.2) between two views
  perturbed per layer by ``eps · sign(h) · normalize(U)``; the BPR term is
  zero in the standalone model and kept in its crosses.
- ``MixGCF``: hard negatives mixed from the positive and ``n_negs``
  candidates per hop, BPR against their hop sum.

The step's draws are the edge masks (``_drop_masks``, or ``edge_masks``
given to ``cal_loss``), SimGCL's noise (:meth:`PluginBase._perturb_noise`)
and MixGCF's mixing weights (:meth:`MixGCFPlugin._mix_weights`); a test
replaces the two methods to feed both packages the same numbers.

Under a profiler recording the masks and the per-edge weights are span
``edge_weights`` (as in ``RAGraphEdge``), SGL's two view forwards span
``sgl.views``, each InfoNCE span ``infonce``, and counter ``infonce.rows``
adds the valid distinct users and items that the InfoNCE compares.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.models.edge.base import (bpr_loss, cal_infonce,
                                                mask_pair, reg_loss_emb,
                                                unique_padded)
from ragraph_tpu_torch.models.edge.ragraph_edge import TemporalLightGCN
from ragraph_tpu_torch.nn.gating import learned_gate
from ragraph_tpu_torch.train.profiling import span


class PluginBase(TemporalLightGCN):
    """The plugin engine: time encoding off in ``vanilla``, a plain
    (dropout-free) learned gate at finetune, no LoRA."""

    use_rag = False
    rows_independent = False

    @property
    def use_time(self):  # type: ignore[override]
        return self.phase != "vanilla"

    def _gate(self, params, all_emb, generator, training: bool = False):
        if self.phase == "finetune":
            return learned_gate(all_emb, params["gating_weight"],
                                params["gating_bias"], 0.0, None)
        return super()._gate(params, all_emb, generator, training)

    def init_params(self, generator: torch.Generator,
                    pretrained_tables: tuple | None = None) -> dict:
        params = super().init_params(generator, pretrained_tables)
        params.pop("user_lora", None)
        params.pop("item_lora", None)
        return params

    # Hooks of the crosses: _evolve runs once on the gated table
    # (EvolveGCN-H/-O), _layer_fuse on each propagated layer (ROLAND's
    # GRU), _hop_prompt on each hop's output before SimGCL's perturbation,
    # so that the noise sees the prompted h and propagates on prompted.
    def _evolve(self, params, all_emb):
        return all_emb

    def _layer_fuse(self, params, h, layer_idx):
        return h

    def _hop_prompt(self, params, h):
        return h

    @staticmethod
    def _perturb_noise(generator, layer: int, shape: tuple,
                       device) -> torch.Tensor:
        """SimGCL's uniform noise of one layer."""
        if generator is None:
            raise ValueError("the SimGCL perturbation draws from a "
                             "generator; pass one")
        return torch.rand(shape, generator=generator, device=device)

    def _propagated(self, params, generator, training, edge_mask,
                    return_layers=False, perturb=False, graph=None,
                    edge_mask_send=None, time_scale: float = 1.0):
        """The per-layer propagation; ``perturb`` adds SimGCL's noise,
        drawn from ``generator``, after each layer."""
        g = self.graph if graph is None else graph
        cfg = self.cfg
        with span("edge_weights"):
            weights, w_send, impl = self._edge_weights(
                g, edge_mask, edge_mask_send, time_scale=time_scale)
        u, it = self._effective_tables(params, generator, training)
        all_emb = self._gate(params, torch.cat([u, it], dim=0), generator,
                             training)
        all_emb = self._evolve(params, all_emb)

        layers = [all_emb]
        h = all_emb
        for layer in range(cfg.num_layers):
            h = self._prop_layer(g, h, weights, w_send, impl)
            h = self._layer_fuse(params, h, layer)
            h = self._hop_prompt(params, h)
            if perturb:
                noise = self._perturb_noise(generator, layer, tuple(h.shape),
                                            h.device)
                noise = noise / torch.clamp_min(
                    torch.linalg.vector_norm(noise, dim=-1, keepdim=True),
                    1e-12)
                h = h + torch.sign(h) * noise * cfg.eps
            layers.append(h)
        if return_layers:
            return layers
        return sum(layers)

    def forward(self, params, *, generator: torch.Generator | None = None,
                training: bool = False, edge_mask=None, edge_mask_send=None,
                time_scale: float = 1.0, max_time_step=None,
                perturb: bool = False, graph=None, resources=None):
        """Returns ``(user_emb, item_emb)``; ``max_time_step`` and
        ``resources`` are taken and left unused, as in the JAX package."""
        g = self.graph if graph is None else graph
        res = self._propagated(params, generator, training, edge_mask,
                               perturb=perturb, graph=g,
                               edge_mask_send=edge_mask_send,
                               time_scale=time_scale)
        return res[: g.num_users], res[g.num_users:]


class SGLPlugin(PluginBase):
    """SGL: edge-drop contrastive views on top of BPR."""

    def cal_loss(self, params, batch, generator, graph=None, resources=None,
                 edge_masks=None):
        """``edge_masks``, when given, holds the step's three mask pairs
        ``(receiver order, sender order)``: the edge dropout and the two
        0.9-keep view subsamples."""
        users, pos_items, neg_items = (t.long() for t in batch)
        cfg = self.cfg
        g = self.graph if graph is None else graph
        keep = 1.0 - cfg.edge_dropout
        with span("edge_weights"):
            if edge_masks is None:
                edge_masks = (self._drop_masks(generator, g, keep),
                              self._drop_masks(generator, g, 0.9),
                              self._drop_masks(generator, g, 0.9))
            (mask, mask_s), (v1, v1_s), (v2, v2_s) = (mask_pair(m)
                                                      for m in edge_masks)
            m1, m2 = mask & v1, mask & v2
            m1_s = mask_s & v1_s if mask_s is not None else None
            m2_s = mask_s & v2_s if mask_s is not None else None

        # time_scale = 1 / keep keeps the static-time half of the weights
        # expectation-preserving under dropout
        user_emb, item_emb = self.forward(params, generator=generator,
                                          training=True, edge_mask=mask,
                                          edge_mask_send=mask_s, graph=g,
                                          time_scale=1.0 / keep)
        rec = bpr_loss(user_emb[users], item_emb[pos_items],
                       item_emb[neg_items])
        u_t, i_t = self._effective_tables(params, None, False)
        reg = cfg.weight_decay * reg_loss_emb(u_t, i_t, users, pos_items,
                                              neg_items)

        view_scale = 1.0 / (keep * 0.9)
        with span("sgl.views"):
            u1, i1 = self.forward(params, generator=generator,
                                  training=True, edge_mask=m1,
                                  edge_mask_send=m1_s, graph=g,
                                  time_scale=view_scale)
            u2, i2 = self.forward(params, generator=generator,
                                  training=True, edge_mask=m2,
                                  edge_mask_send=m2_s, graph=g,
                                  time_scale=view_scale)

        uu, um = unique_padded(users, users.shape[0], "infonce.rows")
        iu, im = unique_padded(pos_items, pos_items.shape[0], "infonce.rows")
        view1 = torch.cat([u1[uu], i1[iu]], dim=0)
        view2 = torch.cat([u2[uu], i2[iu]], dim=0)
        vmask = torch.cat([um, im], dim=0)
        with span("infonce"):
            cl = cfg.lbd * cal_infonce(view1, view2, cfg.temp, mask=vmask)
        return rec + reg + cl, {"rec_loss": rec, "reg_loss": reg,
                                "cl_loss": cl}


class SimGCLPlugin(PluginBase):
    """SimGCL: embedding-perturbation contrastive views. The standalone
    model has no BPR term; the dynamic and prompt crosses keep it
    (``make_dynamic`` and ``make_prompted`` set ``bpr_in_cal_loss``)."""

    bpr_in_cal_loss = False

    def cal_loss(self, params, batch, generator, graph=None, resources=None,
                 edge_masks=None):
        """``edge_masks``: the pair of the fixed 0.5 keep rate."""
        users, pos_items, neg_items = (t.long() for t in batch)
        cfg = self.cfg
        g = self.graph if graph is None else graph
        with span("edge_weights"):
            mask, mask_s = mask_pair(edge_masks if edge_masks is not None
                                     else self._drop_masks(generator, g, 0.5))

        u_t, i_t = self._effective_tables(params, None, False)
        reg = cfg.weight_decay * reg_loss_emb(u_t, i_t, users, pos_items,
                                              neg_items)
        views = [self.forward(params, generator=generator, training=True,
                              edge_mask=mask, edge_mask_send=mask_s,
                              perturb=True, graph=g, time_scale=2.0)
                 for _ in range(2)]
        (uv1, iv1), (uv2, iv2) = views
        uu, um = unique_padded(users, users.shape[0], "infonce.rows")
        iu, im = unique_padded(pos_items, pos_items.shape[0], "infonce.rows")
        with span("infonce"):
            cl = cfg.lbd * (cal_infonce(uv1[uu], uv2[uu], 0.2, mask=um)
                            + cal_infonce(iv1[iu], iv2[iu], 0.2, mask=im))

        if self.bpr_in_cal_loss:
            # the crosses: a plain forward on the same dropped subgraph
            u_p, i_p = self.forward(params, generator=generator,
                                    training=True, edge_mask=mask,
                                    edge_mask_send=mask_s, graph=g,
                                    time_scale=2.0)
            rec = bpr_loss(u_p[users], i_p[pos_items], i_p[neg_items])
        else:
            rec = torch.zeros((), device=reg.device)
        return rec + reg + cl, {"rec_loss": rec, "reg_loss": reg,
                                "cl_loss": cl}


class MixGCFPlugin(PluginBase):
    """MixGCF: positive-mixing and hop-mixing hard negative synthesis."""

    # EdgeTrainer samples (B, n_negs) candidate negatives instead of (B,)
    multi_negs = True

    @staticmethod
    def _mix_weights(generator, shape: tuple, device) -> torch.Tensor:
        """The uniform convex mixing weights ``(B, 1, L + 1, 1)``."""
        if generator is None:
            raise ValueError("MixGCF's mixing draws from a generator; pass "
                             "one")
        return torch.rand(shape, generator=generator, device=device)

    def _mix_negatives(self, user_layers, item_layers, users, neg_candidates,
                       pos_items, generator):
        """Per (user, positive) pair, mix the positive into the ``n_negs``
        candidates per hop with random convex weights and keep the hardest
        candidate per hop by inner product (the first of equal scores)."""
        s_e = user_layers[users]                      # (B, L+1, E)
        p_e = item_layers[pos_items]                  # (B, L+1, E)
        n_e = item_layers[neg_candidates]             # (B, n_negs, L+1, E)
        b, _, hops, e = n_e.shape
        seed = self._mix_weights(generator, (b, 1, hops, 1), n_e.device)
        mixed = seed * p_e[:, None] + (1 - seed) * n_e
        scores = torch.einsum("ble,bnle->bnl", s_e, mixed)
        hard = scores.argmax(dim=1).detach()          # (B, L+1)
        return torch.gather(mixed, 1, hard[:, None, :, None].expand(
            b, 1, hops, e))[:, 0]                     # (B, L+1, E)

    def cal_loss(self, params, batch, generator, graph=None, resources=None,
                 edge_masks=None):
        """``batch`` is ``(users, pos_items, neg_candidates (B, n_negs))``;
        ``edge_masks`` the dropout's pair."""
        users, pos_items, neg_candidates = (t.long() for t in batch)
        cfg = self.cfg
        g = self.graph if graph is None else graph
        keep = 1.0 - cfg.edge_dropout
        with span("edge_weights"):
            mask, mask_s = mask_pair(edge_masks if edge_masks is not None
                                     else self._drop_masks(generator, g, keep))
        layers = self._propagated(params, generator, True, mask,
                                  return_layers=True, graph=g,
                                  edge_mask_send=mask_s,
                                  time_scale=1.0 / keep)
        stacked = torch.stack(layers, dim=1)           # (N, L+1, E)
        user_layers = stacked[: g.num_users]
        item_layers = stacked[g.num_users:]
        neg_emb = self._mix_negatives(user_layers, item_layers, users,
                                      neg_candidates, pos_items,
                                      generator).sum(dim=1)
        rec = bpr_loss(user_layers.sum(dim=1)[users],
                       item_layers.sum(dim=1)[pos_items], neg_emb)
        u_t, i_t = self._effective_tables(params, None, False)
        # the regulariser spans the whole flat (B * n_negs) candidate
        # tensor, still over B: an n_negs-fold stronger negative penalty
        reg = cfg.weight_decay * reg_loss_emb(u_t, i_t, users, pos_items,
                                              neg_candidates.reshape(-1))
        return rec + reg, {"rec_loss": rec, "reg_loss": reg}


class LightGCNPlugin(PluginBase):
    """The plugin LightGCN: the PluginBase engine with plain BPR (the
    inherited ``TemporalLightGCN.cal_loss``)."""
