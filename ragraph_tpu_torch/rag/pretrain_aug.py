"""GraphCL pretraining augmentations (counterpart of
``ragraph_tpu/rag/pretrain_aug.py``): feature masking, edge rewriting, node
dropping and random-walk subgraphs, each a masked, shape-preserving
transform of a padded graph ``features (N, F)``, ``adj (N, N)``,
``node_mask (N,)``.

Each augmentation is split in two: ``draw_view`` draws its random values
from a ``torch.Generator``, and ``aug_*`` applies them, a pure function of
the graph and the draws, so that a caller (a test) can hand in another
package's draws. The draws of one view, by flavor:

- ``mask``, ``node``: ``u (N,)`` uniforms; a node is kept where ``u >=
  drop_percent``;
- ``edge``: ``u_drop (N, N)`` and ``u_add (N, N)`` uniforms;
- ``subgraph``: ``center`` (a node index) and ``gumbel (steps, N)``, one
  row of Gumbel noise per step of the walk.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.core.graph import normalize_adj_dense

FLAVORS = ("edge", "mask", "node", "subgraph")


def _mask_or_all(node_mask, n: int, device) -> torch.Tensor:
    if node_mask is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return node_mask.bool()


def aug_random_mask(features: torch.Tensor, u: torch.Tensor,
                    drop_percent: float = 0.2,
                    node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Zero the feature rows of the nodes with ``u < drop_percent``."""
    keep = u >= drop_percent
    if node_mask is not None:
        keep = keep | ~node_mask.bool()     # padding rows are zero already
    return features * keep[:, None].to(features.dtype)


def aug_random_edge(adj: torch.Tensor, u_drop: torch.Tensor,
                    u_add: torch.Tensor, drop_percent: float = 0.2,
                    node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Drop each undirected edge with probability ``drop_percent / 4`` and
    add new pairs among the non-edges at the rate that adds as many edges
    in expectation; symmetric. The kept upper triangle keeps ``adj``'s
    values (a normalised ``adj`` stays weighted where it was not
    rewritten), as in the JAX package."""
    n = adj.shape[0]
    m = _mask_or_all(node_mask, n, adj.device)
    pair_valid = m[:, None] & m[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=adj.device), 1) & pair_valid
    rate = drop_percent / 4.0
    drop = (u_drop < rate) & (adj > 0) & upper
    num_edges = ((adj > 0) & upper).sum().to(torch.float32)
    num_pairs = torch.clamp_min(upper.sum(), 1).to(torch.float32)
    add = (u_add < rate * num_edges / num_pairs) & (adj == 0) & upper
    new_upper = torch.where(drop, 0.0, torch.where(add, 1.0,
                                                   torch.triu(adj, 1)))
    return new_upper + new_upper.T


def aug_drop_node(features: torch.Tensor, adj: torch.Tensor,
                  u: torch.Tensor, drop_percent: float = 0.2,
                  node_mask: torch.Tensor | None = None):
    """Drop the nodes with ``u < drop_percent`` by masking them out;
    returns ``(features, adj, member_mask)``."""
    m = _mask_or_all(node_mask, features.shape[0], features.device)
    new_mask = m & (u >= drop_percent)
    return _restrict(features, adj, new_mask)


def _restrict(features, adj, member):
    mf = member.to(features.dtype)
    ma = member.to(adj.dtype)
    return features * mf[:, None], adj * ma[:, None] * ma[None, :], member


def aug_subgraph(features: torch.Tensor, adj: torch.Tensor,
                 center: torch.Tensor, gumbel: torch.Tensor,
                 drop_percent: float = 0.2,
                 node_mask: torch.Tensor | None = None):
    """Random-walk-grown induced subgraph, as masking: from ``center``, each
    step adds the frontier node (an unvisited neighbour of the subgraph)
    with the largest ``gumbel[step]``, while the subgraph is smaller than
    ``floor(real nodes * (1 - drop_percent))`` and the frontier is not
    empty. ``gumbel`` has one row per step (the JAX package takes ``N``
    steps). Returns ``(features, adj, member_mask)``."""
    n = features.shape[0]
    m = _mask_or_all(node_mask, n, features.device)
    n_real = torch.clamp_min(m.to(torch.float32).sum(), 1.0)
    target = torch.floor(n_real * (1.0 - drop_percent)).to(torch.int64)
    neighbor = ((adj > 0) & (m[:, None] & m[None, :])).to(torch.float32)
    member = torch.zeros(n, dtype=torch.bool, device=features.device)
    member[center.long()] = True
    for step in range(gumbel.shape[0]):
        frontier = ((member.to(torch.float32) @ neighbor) > 0) & ~member
        add = frontier.any() & (member.sum() < target)
        pick = torch.argmax(torch.where(frontier, gumbel[step], -torch.inf))
        member = member | (add & (torch.arange(n, device=member.device)
                                  == pick))
    return _restrict(features, adj, member)


def draw_view(generator: torch.Generator, flavor: str,
              node_mask: torch.Tensor) -> dict:
    """The random values of one ``flavor`` view of a graph with
    ``node_mask (N,)``, on its device (see the module docstring); a
    ``subgraph`` walk takes ``N`` steps, as the JAX package's does."""
    n, dev = node_mask.shape[0], node_mask.device
    if flavor in ("mask", "node"):
        return {"u": torch.rand(n, generator=generator, device=dev)}
    if flavor == "edge":
        return {"u_drop": torch.rand((n, n), generator=generator, device=dev),
                "u_add": torch.rand((n, n), generator=generator, device=dev)}
    if flavor == "subgraph":
        # an empty graph draws from all rows (no host read to find out)
        probs = node_mask.to(torch.float32) \
            + (~node_mask.any()).to(torch.float32)
        center = torch.multinomial(probs, 1, generator=generator)[0]
        e = torch.empty((n, n), device=dev)
        return {"center": center,
                "gumbel": -torch.log(e.exponential_(generator=generator))}
    raise ValueError(f"unknown GraphCL flavor: {flavor!r}")


def make_graphcl_views(flavor: str, features: torch.Tensor,
                       adj: torch.Tensor, node_mask: torch.Tensor | None,
                       draws, drop_percent: float = 0.2,
                       normalize: bool = True):
    """Two augmented ``(features, adj, mask)`` views for a GraphCL flavor,
    from ``draws``, a pair of :func:`draw_view` dicts:

    - ``edge``: clean features, two rewritten adjacencies;
    - ``mask``: two feature-masked views, the clean adjacency;
    - ``node``: two node-dropped views;
    - ``subgraph``: two random-walk induced subgraphs.

    ``normalize=True`` normalises each view's adjacency (``D^-1/2 (A + I)
    D^-1/2`` on its mask), also when ``adj`` is normalised already: the JAX
    CLI passes the normalised batch adjacency, so it is normalised twice.
    """
    def norm(a, m):
        return normalize_adj_dense(a, m, add_self_loops=True) \
            if normalize else a

    d1, d2 = draws
    if flavor == "edge":
        return tuple((features,
                      norm(aug_random_edge(adj, d["u_drop"], d["u_add"],
                                           drop_percent, node_mask),
                           node_mask), node_mask) for d in (d1, d2))
    if flavor == "mask":
        a = norm(adj, node_mask)
        return tuple((aug_random_mask(features, d["u"], drop_percent,
                                      node_mask), a, node_mask)
                     for d in (d1, d2))
    if flavor == "node":
        views = [aug_drop_node(features, adj, d["u"], drop_percent,
                               node_mask) for d in (d1, d2)]
    elif flavor == "subgraph":
        views = [aug_subgraph(features, adj, d["center"], d["gumbel"],
                              drop_percent, node_mask) for d in (d1, d2)]
    else:
        raise ValueError(f"unknown GraphCL flavor: {flavor!r}")
    return tuple((f, norm(a, m), m) for f, a, m in views)
