"""Plain PyTorch reference of RAGraph-edge: the training step (temporal
LightGCN propagation, the learned gate, retrieval and its fusion, BPR and
L2 loss, Adam) and the evaluation (the same forward without dropout, then
recall@k and ndcg@k over the test users with the history masked).

It is written from the model's definition (RAGraph, Jiang et al., NeurIPS
2024; GraphPro, Yang et al., WWW 2024) and the configuration file, and
imports nothing of the program. It computes in float32 with TF32 off.
Where the configuration states a lower precision for a part (``precision``
in the file: propagation rows, edge weights and their gradients in
bfloat16, retrieval scores of bfloat16 rows), the reference rounds that
part's operands to it and keeps its sums in float32; ``dtype`` selects that
rounding, so the same code, given float8 with a per-tensor scale, is the
control one precision below.

The graph is rebuilt here from the interactions: the bidirectional edges
(user to item, item to user), ordered by receiver, stably, which gives
each edge the id that the edge dropout hashes; symmetric degree
normalisation; the static per-receiver softmax of the binned edge times,
in float64.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

RETRIEVAL_CHUNK = 4096    # queries per block of the retrieval
TIE_SPAN = 16             # candidates past k that settle most ties
# the configuration's stated rounding of rows, and the control's, one below
DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32; float8 with a
    per-tensor scale (its largest magnitude at the format's maximum)."""
    if dtype is None:
        return x.float()
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        amax = x.detach().abs().max().float().clamp_min(1e-30)
        scale = torch.finfo(dtype).max / amax
        return (x.float() * scale).to(dtype).float() / scale
    return x.to(dtype).float()


def l2n(x: torch.Tensor) -> torch.Tensor:
    n = x.norm(dim=-1, keepdim=True)
    return x / n.clamp_min(1e-12)


@dataclasses.dataclass
class Graph:
    senders: torch.Tensor      # int64, receiver-ordered edges
    receivers: torch.Tensor
    norm: torch.Tensor         # float32 degree normalisation
    time_w: torch.Tensor       # float32 per-receiver time softmax
    num_users: int
    num_items: int
    indptr: torch.Tensor       # CSR bounds of the receivers
    by_sender: torch.Tensor    # the edges in sender order
    sender_indptr: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items


def _bounds(ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    out[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
    return out


def build_graph(users: np.ndarray, items: np.ndarray, times: np.ndarray,
                num_users: int, num_items: int, hour_interval: float,
                device) -> Graph:
    n = num_users + num_items

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    u, it, t = put(users), put(items) + num_users, put(times)
    step = 1 + torch.div(t - t.min(), int(hour_interval * 3600),
                         rounding_mode="floor")
    deg = (torch.bincount(u, minlength=n)
           + torch.bincount(it, minlength=n)).double()
    inv = torch.where(deg > 0, deg.clamp_min(1.0) ** -0.5, 0.0)
    w = inv[u] * inv[it]
    recv, order = torch.sort(torch.cat([it, u]), stable=True)
    send = torch.cat([u, it])[order]
    w = torch.cat([w, w])[order]
    ts = torch.cat([step, step])[order].double()
    ts = (ts - ts.min()) / (ts.max() - ts.min()).clamp_min(1e-12)
    ex = torch.exp(ts)
    den = torch.zeros(n, dtype=torch.float64, device=device) \
        .index_add_(0, recv, ex)
    by_sender = torch.sort(send, stable=True).indices
    return Graph(send, recv, w.float(), (ex / den[recv]).float(), num_users,
                 num_items, _bounds(recv, n), by_sender, _bounds(send, n))


def keep_mask(salt: int, n_edges: int, keep_rate: float, device):
    """Edge dropout: edge ``e`` is kept when a murmur3-style finaliser of
    ``e * 0x9E3779B9 + salt`` (32-bit arithmetic) falls below
    ``keep_rate * 2**32``."""
    x = np.arange(n_edges, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x * np.uint32(0x9E3779B9) + np.uint32(salt & 0xFFFFFFFF)
        x ^= x >> np.uint32(16)
        x = x * np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x = x * np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    thresh = min(round(keep_rate * 4294967296.0), 4294967295)
    return torch.from_numpy(x.astype(np.int64) < thresh).to(device)


def _propagate(h, w, g: Graph, dtype, backward: bool = False):
    """``out[r] = sum_e w[e] h[s(e)]`` over the edges into each node ``r``
    (``backward``: over the edges out of it), as one sparse-dense product
    of the operands rounded to ``dtype``, summed in float32."""
    n = g.num_nodes
    wr = rounded(w, dtype)
    if backward:
        parts = (g.sender_indptr, g.receivers[g.by_sender], wr[g.by_sender])
    else:
        parts = (g.indptr, g.senders, wr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" support
        a = torch.sparse_csr_tensor(*parts, (n, n), check_invariants=False)
    return torch.sparse.mm(a, rounded(h, dtype))


class _Layer(torch.autograd.Function):
    """One propagation layer; its backward is the same sum over the
    reversed edges. Operands (rows, weights, incoming gradients) are
    rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, h, w, g, dtype):
        ctx.w, ctx.g, ctx.dtype = w, g, dtype
        return _propagate(h, w, g, dtype)

    @staticmethod
    def backward(ctx, grad):
        return _propagate(grad, ctx.w, ctx.g, ctx.dtype, backward=True), \
            None, None, None


def top_k_lowest_ties(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``(Q, k)`` column indices of each row's ``k`` largest scores, equal
    scores taken in ascending index order."""
    span = min(k + TIE_SPAN, scores.shape[1])
    top = torch.topk(scores, span, dim=1)
    kth = top.values[:, k - 1:k]
    big = scores.shape[1]
    # rank the candidates: those above the k-th first, then the tied ones
    # by index
    key = torch.where(top.values > kth, -1,
                      torch.where(top.values == kth, top.indices, big))
    pick = torch.topk(-key, k, dim=1).indices
    idx = torch.gather(top.indices, 1, pick)
    # rows whose tie runs past the candidates: the whole row decides
    wide = torch.nonzero((top.values[:, -1] == kth[:, 0])
                         & (span < scores.shape[1])).flatten()
    if len(wide):
        sub, kw = scores[wide], kth[wide]
        above, tied = sub > kw, sub == kw
        need = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
        take = above | (tied & (tied.cumsum(1, dtype=torch.int32) <= need))
        idx[wide] = torch.nonzero(take)[:, 1].reshape(-1, k)
    return idx


@dataclasses.dataclass
class Model:
    """What the reference needs of a configuration."""
    cfg: dict
    phase: str
    graph: Graph
    dtype: object                       # the rounding of rows and scores
    keys: torch.Tensor | None = None    # the retrieval library
    values: torch.Tensor | None = None
    # the first retrieval's ``(ids, mean)`` over every node, kept
    first_retrieval: tuple | None = None

    def layers(self, h0, w):
        out = [h0]
        for _ in range(int(self.cfg["num_layers"])):
            out.append(_Layer.apply(out[-1], w, self.graph, self.dtype))
        return out

    def retrieved(self, queries: torch.Tensor):
        """``(ids, mean)``: each query's ``k`` library rows of highest
        cosine score and the mean of their values; of rows with equal
        scores the lowest indices are taken (many keys are equal: nodes
        with no edges in the stage, and nodes of one degree on one
        neighbour)."""
        k = int(self.cfg["finetune"]["retrieve_num"])
        keys = rounded(l2n(self.keys), self.dtype)
        ids, means = [], []
        for s in range(0, len(queries), RETRIEVAL_CHUNK):
            q = rounded(l2n(queries[s:s + RETRIEVAL_CHUNK]), self.dtype)
            idx = top_k_lowest_ties(q @ keys.T, k)
            ids.append(idx)
            means.append(self.values[idx].mean(dim=1))
        return torch.cat(ids), torch.cat(means)

    def forward(self, params: dict, w: torch.Tensor):
        """``(user_emb, item_emb)`` under edge weights ``w``."""
        h0 = torch.cat([params["user_embedding"], params["item_embedding"]])
        if self.phase == "finetune":
            h0 = h0 * torch.sigmoid(h0 @ params["gating_weight"]
                                    + params["gating_bias"])
        layers = self.layers(h0, w)
        res = layers[0]
        for h in layers[1:]:
            res = res + h
        if self.phase == "finetune":
            a = float(self.cfg["finetune"]["retrieve_weight"])
            with torch.no_grad():
                ids, rag = self.retrieved(layers[0].detach())
            if self.first_retrieval is None:
                self.first_retrieval = (ids, rag)
            res = (1.0 - a) * res + a * rag
        u = self.graph.num_users
        return res[:u], res[u:]

    def weights(self, mask=None, keep_rate: float = 1.0):
        w = 0.5 * self.graph.norm + (0.5 / keep_rate) * self.graph.time_w
        return w if mask is None else torch.where(mask, w, 0.0)

    def build_library(self, tables: dict) -> None:
        """Keys: the last layer; values: the even layers' sum; of the
        pretrained tables propagated in float32 over the degree weights."""
        h0 = torch.cat([tables["user_embedding"], tables["item_embedding"]])
        layers = [h0.float()]
        for _ in range(int(self.cfg["num_layers"])):
            layers.append(_propagate(layers[-1], self.graph.norm,
                                     self.graph, None))
        self.keys = layers[-1]
        self.values = sum(layers[0::2])

    def loss(self, params: dict, batch, mask):
        users, pos, neg = (torch.as_tensor(a, dtype=torch.long,
                                           device=self.graph.norm.device)
                           for a in batch)
        keep = 1.0 - float(self.cfg["edge_dropout"])
        u_emb, i_emb = self.forward(params, self.weights(mask, keep))
        ue = u_emb[users]
        d = (ue * i_emb[pos]).sum(1) - (ue * i_emb[neg]).sum(1)
        rec = -torch.log(1e-10 + torch.sigmoid(d)).mean()
        reg = 0.5 * ((params["user_embedding"][users] ** 2).sum()
                     + (params["item_embedding"][pos] ** 2).sum()
                     + (params["item_embedding"][neg] ** 2).sum()) \
            / len(users)
        return rec + float(self.cfg["weight_decay"]) * reg


def build(cfg: dict, phase: str, inputs: dict, tables: dict, device,
          dtype: str) -> Model:
    """The reference model of a cell: the graph from the interactions of
    ``inputs["train"]``, and in the finetune phase the library from the
    pretrained tables; rows and scores rounded to ``DTYPES[dtype]``."""
    tr = inputs["train"]
    g = build_graph(tr["users"], tr["items"], tr["times"],
                    int(cfg["num_users"]), int(cfg["num_items"]),
                    float(cfg["hour_interval"]), device)
    m = Model(cfg, phase, g, DTYPES[dtype])
    if phase == "finetune":
        m.build_library(tables["library"])
    return m


def train_steps(model: Model, params: dict, batches: list, salts: list):
    """Adam over ``batches`` from ``params``. Returns the losses, each
    leaf's first gradient and each leaf's change after the last step."""
    cfg = model.cfg
    b1, b2 = (float(b) for b in cfg["adam_betas"])
    lr, eps = float(cfg["lr"]), float(cfg["adam_eps"])
    keep = 1.0 - float(cfg["edge_dropout"])
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    n_edges = len(model.graph.norm)
    for t, (batch, salt) in enumerate(zip(batches, salts), start=1):
        mask = keep_mask(salt, n_edges, keep, model.graph.norm.device)
        loss = model.loss(p, batch, mask)
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
    change = {k: (p[k].detach() - params[k].float()) for k in p}
    return losses, first_grad, change


def evaluate(user_emb, item_emb, test_pairs: np.ndarray,
             hist_pairs: np.ndarray, k: int, batch: int = 4096):
    """Recall@k and ndcg@k, averaged over the test users: the items of a
    user's history scored out, the top k of the rest against the user's
    distinct test items."""
    dev = user_emb.device
    users, inv = np.unique(test_pairs[:, 0], return_inverse=True)
    n_items = item_emb.shape[0]
    truth = np.unique(inv.astype(np.int64) * n_items + test_pairs[:, 1])
    n_true = np.bincount(truth // n_items, minlength=len(users))
    pos = np.searchsorted(users, hist_pairs[:, 0])
    pos = np.minimum(pos, len(users) - 1)
    seen = users[pos] == hist_pairs[:, 0]
    hist_rows, hist_items = pos[seen], hist_pairs[seen, 1]
    disc = 1.0 / np.log2(np.arange(2, k + 2))
    recall = ndcg = 0.0
    for s in range(0, len(users), batch):
        e = min(s + batch, len(users))
        scores = user_emb[torch.from_numpy(users[s:e]).to(dev)].float() \
            @ item_emb.float().T
        sel = (hist_rows >= s) & (hist_rows < e)
        scores[torch.from_numpy(hist_rows[sel] - s).to(dev),
               torch.from_numpy(hist_items[sel]).to(dev)] = -torch.inf
        top = torch.topk(scores, k, dim=1).indices.cpu().numpy()
        keys = np.arange(s, e)[:, None] * n_items + top
        hits = np.isin(keys, truth)
        nt = n_true[s:e]
        recall += float((hits.sum(1) / nt).sum())
        idcg = np.array([disc[:min(n, k)].sum() for n in nt])
        ndcg += float(((hits * disc).sum(1) / idcg).sum())
    return recall / len(users), ndcg / len(users)
