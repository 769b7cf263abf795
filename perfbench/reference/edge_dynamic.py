"""Plain PyTorch reference of SGL crossed with ROLAND: the training step of
the dynamic contrastive baseline (three edge masks, three forwards of
LightGCN propagation each followed by a GRU cell against the meta model's
layer, BPR + L2 + InfoNCE between the two views, autograd and Adam).

It is written from the models' definitions (SGL, Wu et al., SIGIR 2021;
ROLAND, You, Du and Leskovec, KDD 2022; their cross as RAGraph's
``SGL_dynamic.py`` trains it) and the configuration file, and imports
nothing of the program. It computes in float32 with TF32 off. The graph,
the edge-dropout hash and the propagation layer are those of
:mod:`perfbench.reference.edge`; where the configuration states bfloat16
(propagation rows, edge weights and their gradients) the operands are
rounded to it and the sums kept in float32. ``dtype`` "fp8" is the control
one precision below: propagation in float8 with a per-tensor scale, and the
GRU's and the InfoNCE's operands, stated in float32, rounded to bfloat16.

One step, from its three salts (the dropout's, then each view's):

- masks: ``m`` keeps an edge with probability ``1 - edge_dropout``; each
  view keeps ``view_keep`` of ``m``'s survivors (``m & v1``, ``m & v2``);
- weights: the symmetric degree normalisation under each mask (the cross
  has no time encoding and no gate);
- a forward: ``h_0`` the tables; for each layer ``l``, ``x = A h_l`` (the
  propagation) and ``h_{l+1} = GRU(x, meta_{l+1})``; the output is
  ``h_0 + ... + h_L``;
- the loss: BPR on the dropout's forward, L2 of the batch's table rows over
  the batch, and ``lbd`` times the InfoNCE at temperature ``temp`` between
  the two views' cosine-normalised rows of the batch's distinct users and
  distinct positive items, each row against every other row of the other
  view.

The meta layers are the plain propagation of the stage's starting tables,
``meta_{l+1} = A meta_l`` with ``meta_0`` the tables, under the unmasked
weights.

Departures from the published description, all as the cross is trained in
RAGraph: the GRU's hidden state is the meta model's layer and its input the
propagated layer (ROLAND updates node states across snapshots; here within
one stage against the detached meta model); the views drop edges of the
already dropped graph (SGL's edge dropout views are drawn from the whole
graph); the InfoNCE adds 1e-5 inside its logarithm, and the BPR 1e-10.
"""

from __future__ import annotations

import dataclasses

import torch

# the sibling reference's graph, dropout hash and propagation layer
from .edge import (DTYPES, Graph, _Layer, _propagate, build_graph, keep_mask,
                   l2n, no_tf32, rounded)

__all__ = ["Model", "build", "flatten", "no_tf32", "train_steps", "unflatten"]

# the rounding of the GRU's and the InfoNCE's operands: float32 as the
# configuration states them, bfloat16 in the control
GRU_DTYPES = {"bf16": None, "fp8": torch.bfloat16}


def gru(p: dict, x: torch.Tensor, h: torch.Tensor, dtype) -> torch.Tensor:
    """One GRU cell, gates reset, update, new (``torch.nn.GRUCell``):
    ``r = s(W_r x + b_ir + U_r h + b_hr)``, ``z`` the same,
    ``n = tanh(W_n x + b_in + r (U_n h + b_hn))``, ``h' = (1 - z) n + z h``."""
    e = x.shape[1]
    xr, hr = rounded(x, dtype), rounded(h, dtype)
    w_ih, w_hh = rounded(p["w_ih"], dtype), rounded(p["w_hh"], dtype)
    b_ih, b_hh = p["b_ih"], p["b_hh"]
    gate = {}
    for i, name in enumerate("rzn"):
        rows = slice(i * e, (i + 1) * e)
        gate[name] = (xr @ w_ih[rows].T + b_ih[rows],
                      hr @ w_hh[rows].T + b_hh[rows])
    r = torch.sigmoid(gate["r"][0] + gate["r"][1])
    z = torch.sigmoid(gate["z"][0] + gate["z"][1])
    n = torch.tanh(gate["n"][0] + r * gate["n"][1])
    return (1.0 - z) * n + z * h


def infonce(a: torch.Tensor, b: torch.Tensor, temp: float, dtype):
    """The mean over rows of ``-log(e^{a_i.b_i/t} / sum_j e^{a_i.b_j/t} +
    1e-5)`` of the cosine-normalised rows."""
    a, b = l2n(a), l2n(b)
    ar, br = rounded(a, dtype), rounded(b, dtype)
    pos = torch.exp((ar * br).sum(dim=1) / temp)
    ttl = torch.exp(ar @ br.T / temp).sum(dim=1)
    return -torch.log(pos / ttl + 1e-5).mean()


@dataclasses.dataclass
class Model:
    """What the reference needs of a configuration."""
    cfg: dict
    graph: Graph
    dtype: object                  # the rounding of propagation operands
    gru_dtype: object              # the rounding of the GRU's and InfoNCE's
    meta_layers: list | None = None

    def forward(self, params: dict, w: torch.Tensor):
        """``(user_emb, item_emb)`` under edge weights ``w``."""
        h = torch.cat([params["user_embedding"], params["item_embedding"]])
        layers = [h]
        for layer in range(int(self.cfg["num_layers"])):
            x = _Layer.apply(h, w, self.graph, self.dtype)
            h = gru(params["gru"], x, self.meta_layers[layer + 1],
                    self.gru_dtype)
            layers.append(h)
        res = sum(layers)
        u = self.graph.num_users
        return res[:u], res[u:]

    def set_meta(self, tables: dict) -> None:
        """The meta model's layers: the plain propagation of the stage's
        starting tables under the unmasked weights, detached."""
        with torch.no_grad():
            h = torch.cat([tables["user_embedding"],
                           tables["item_embedding"]]).float()
            layers = [h]
            for _ in range(int(self.cfg["num_layers"])):
                layers.append(_propagate(layers[-1], self.graph.norm,
                                         self.graph, self.dtype))
        self.meta_layers = layers

    def loss(self, params: dict, batch, salts):
        cfg, g = self.cfg, self.graph
        dev = g.norm.device
        users, pos, neg = (torch.as_tensor(a, dtype=torch.long, device=dev)
                           for a in batch)
        n_edges = len(g.norm)
        keep = 1.0 - float(cfg["edge_dropout"])
        view_keep = float(cfg["view_keep"])
        m = keep_mask(salts[0], n_edges, keep, dev)
        views = [m & keep_mask(s, n_edges, view_keep, dev)
                 for s in salts[1:3]]

        u_emb, i_emb = self.forward(params, torch.where(m, g.norm, 0.0))
        ue = u_emb[users]
        d = (ue * i_emb[pos]).sum(1) - (ue * i_emb[neg]).sum(1)
        rec = -torch.log(1e-10 + torch.sigmoid(d)).mean()
        reg = 0.5 * ((params["user_embedding"][users] ** 2).sum()
                     + (params["item_embedding"][pos] ** 2).sum()
                     + (params["item_embedding"][neg] ** 2).sum()) \
            / len(users)

        (u1, i1), (u2, i2) = (self.forward(params,
                                           torch.where(v, g.norm, 0.0))
                              for v in views)
        uu, iu = torch.unique(users), torch.unique(pos)
        cl = infonce(torch.cat([u1[uu], i1[iu]]),
                     torch.cat([u2[uu], i2[iu]]), float(cfg["temp"]),
                     self.gru_dtype)
        return rec + float(cfg["weight_decay"]) * reg \
            + float(cfg["lbd"]) * cl


def build(cfg: dict, phase: str, inputs: dict, tables: dict, device,
          dtype: str) -> Model:
    """The reference model of a cell: the graph from the interactions of
    ``inputs["train"]`` and the meta layers from the starting tables
    (``tables["params"]``); operands rounded as ``dtype`` says."""
    if phase != "finetune":
        raise ValueError("the dynamic crosses train in the finetune phase")
    tr = inputs["train"]
    g = build_graph(tr["users"], tr["items"], tr["times"],
                    int(cfg["num_users"]), int(cfg["num_items"]),
                    float(cfg["hour_interval"]), device)
    m = Model(cfg, g, DTYPES[dtype], GRU_DTYPES[dtype])
    m.set_meta(tables["params"])
    return m


def flatten(params: dict) -> dict:
    """``{"gru": {"w_ih": ...}, ...}`` as ``{"gru.w_ih": ..., ...}``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        top, _, sub = k.partition(".")
        if sub:
            out.setdefault(top, {})[sub] = v
        else:
            out[k] = v
    return out


def train_steps(model: Model, params: dict, batches: list, salts: list):
    """Adam over ``batches`` from ``params``, each step's three masks from
    its three salts (``salts[t]``). Returns the losses, each leaf's first
    gradient and each leaf's change after the last step, leaves named
    ``gru.w_ih`` and so on."""
    cfg = model.cfg
    b1, b2 = (float(b) for b in cfg["adam_betas"])
    lr, eps = float(cfg["lr"]), float(cfg["adam_eps"])
    start = flatten(params)
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for t, (batch, step_salts) in enumerate(zip(batches, salts), start=1):
        loss = model.loss(unflatten(p), batch, step_salts)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, x), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                x.sub_(lr * mh / (vh.sqrt() + eps))
    change = {k: (p[k].detach() - start[k].float()) for k in p}
    return losses, first_grad, change
