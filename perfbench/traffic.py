"""The one generator of the benchmark's inputs: interactions, splits, test
rows and initial tables, all from ``--seed``.

A configuration gives the counts (users, items, interactions), the skew
and the sizes of the splits; the phase says which split the graph holds
(pretrain: all the interactions; finetune: the finetune split), and the
loop whether it needs test rows. The same seed gives the same inputs;
every seed gives the same sizes. Host data is made with vectorised numpy, tables on the device with
one ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

T0 = 1_600_000_000        # the first timestamp, in seconds


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    """An independent numpy generator per (seed, purpose)."""
    return np.random.default_rng([int(seed) % (1 << 63), purpose])


def torch_generator(seed: int, purpose: int,
                    device: torch.device) -> torch.Generator:
    """An independent torch generator on ``device`` per (seed, purpose)."""
    mixed = np.random.SeedSequence([int(seed) % (1 << 63), purpose]) \
        .generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device).manual_seed(int(mixed) >> 1)


def skewed_ids(rng: np.random.Generator, n_ids: int, n: int,
               alpha: float) -> np.ndarray:
    """``n`` ids of ``[0, n_ids)`` drawn with p proportional to
    ``(rank + 1) ** -alpha`` over a random ranking of the ids."""
    rank_of = rng.permutation(n_ids)
    cdf = np.cumsum(np.arange(1, n_ids + 1, dtype=np.float64) ** -alpha)
    ranks = np.searchsorted(cdf, rng.random(n) * cdf[-1], side="right")
    return rank_of[np.minimum(ranks, n_ids - 1)].astype(np.int64)


def interactions(cfg: dict, seed: int) -> dict:
    """All interactions, sorted by time: ``users``, ``items``, ``times``
    (int64 arrays)."""
    rng = rng_for(seed, 1)
    n, alpha = int(cfg["num_interactions"]), float(cfg["popularity_exponent"])
    users = skewed_ids(rng, int(cfg["num_users"]), n, alpha)
    items = skewed_ids(rng, int(cfg["num_items"]), n, alpha)
    times = np.sort(T0 + rng.integers(0, int(cfg["days"]) * 86400, n))
    return {"users": users, "items": items, "times": times}


def split_bounds(cfg: dict) -> list[int]:
    """Row bounds of the time-ordered splits: pretrain, finetune, the first
    test stage (the later stages' rows follow, up to ``num_interactions``)."""
    pre, ft, test = (int(cfg[k]) for k in (
        "pretrain_interactions", "finetune_interactions",
        "test_interactions"))
    if pre + ft + test > int(cfg["num_interactions"]):
        raise ValueError("the splits hold more than num_interactions")
    return [0, pre, pre + ft, pre + ft + test]


def _csr(owner: np.ndarray, other: np.ndarray, n_owner: int):
    order = np.argsort(owner, kind="stable")
    indptr = np.zeros(n_owner + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(owner, minlength=n_owner))
    return indptr, other[order]


def _pick(rng, indptr, vals, who):
    """A random neighbour of each of ``who`` (all of which have one)."""
    lo, hi = indptr[who], indptr[who + 1]
    return vals[lo + (rng.random(len(who)) * (hi - lo)).astype(np.int64)]


def held_out_pairs(cfg: dict, seed: int, hist_users: np.ndarray,
                   hist_items: np.ndarray, n_rows: int) -> np.ndarray:
    """``(n_rows, 2)`` test pairs of the stage: ``test_users`` users of
    those with a history, each at least once; half
    the items two hops from the user's own items (user -> own item ->
    another user of it -> that user's item), half drawn by popularity."""
    rng = rng_for(seed, 2)
    n_u, n_i = int(cfg["num_users"]), int(cfg["num_items"])
    active = np.unique(hist_users)
    n_test = min(len(active), int(cfg["test_users"]))
    test_users = rng.choice(active, n_test, replace=False)
    users = np.concatenate([test_users, rng.choice(
        test_users, max(n_rows - n_test, 0))])
    u_ptr, u_items = _csr(hist_users, hist_items, n_u)
    i_ptr, i_users = _csr(hist_items, hist_users, n_i)
    own = _pick(rng, u_ptr, u_items, users)
    other = _pick(rng, i_ptr, i_users, own)
    two_hop = _pick(rng, u_ptr, u_items, other)
    popular = skewed_ids(rng, n_i, len(users),
                         float(cfg["popularity_exponent"]))
    items = np.where(rng.random(len(users)) < 0.5, two_hop, popular)
    return np.stack([users, items], axis=1)


def as_rows(users, items, times=None) -> list:
    """Rows of the program's loader: ``(user, item, time)`` tuples."""
    if times is None:
        return list(zip(users.tolist(), items.tolist()))
    return list(zip(users.tolist(), items.tolist(), times.tolist()))


def make_inputs(cfg: dict, phase: str, seed: int, test_rows: bool) -> dict:
    """The host inputs of a cell: the graph's rows (``train``: every
    interaction in the pretrain phase, the finetune split in the finetune
    phase), the history that evaluation masks (``hist``, the earlier
    splits), and, with ``test_rows``, the first test stage's pairs
    (``test``, else None). Arrays, not yet the loader's row lists."""
    data = interactions(cfg, seed)
    b = split_bounds(cfg)
    if phase == "pretrain":
        lo, hi, hist_hi = 0, int(cfg["num_interactions"]), 0
    elif phase == "finetune":
        lo, hi, hist_hi = b[1], b[2], b[1]
    else:
        raise ValueError(f"unknown phase {phase!r}")
    sl = slice(lo, hi)
    out = {"train": {k: v[sl] for k, v in data.items()},
           "hist": {k: v[:hist_hi] for k, v in data.items()},
           "test": None}
    if test_rows:
        hu = np.concatenate([out["hist"]["users"], out["train"]["users"]])
        hi_ = np.concatenate([out["hist"]["items"], out["train"]["items"]])
        out["test"] = held_out_pairs(cfg, seed, hu, hi_, b[3] - b[2])
    return out


def _xavier(gen, rows, cols, device):
    bound = math.sqrt(6.0 / (rows + cols))
    return (torch.rand((rows, cols), generator=gen, device=device) * 2.0
            - 1.0) * bound


def _unit_rows(gen, rows, cols, device):
    x = torch.randn((rows, cols), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def make_tables(cfg: dict, phase: str, seed: int,
                device: torch.device) -> dict:
    """The initial parameters (and, in the finetune phase, the library's
    pretrained tables ``library``), made on ``device`` from the seed."""
    gen = torch_generator(seed, 3, device)
    n_u, n_i, e = int(cfg["num_users"]), int(cfg["num_items"]), \
        int(cfg["emb_size"])
    if phase == "pretrain":
        return {"params": {"user_embedding": _xavier(gen, n_u, e, device),
                           "item_embedding": _xavier(gen, n_i, e, device)}}
    if phase != "finetune":
        raise ValueError(f"unknown phase {phase!r}")
    params = {"user_embedding": _unit_rows(gen, n_u, e, device),
              "item_embedding": _unit_rows(gen, n_i, e, device),
              "gating_weight": _xavier(gen, e, e, device),
              "gating_bias": _xavier(gen, 1, e, device)}
    library = {"user_embedding": _unit_rows(gen, n_u, e, device),
               "item_embedding": _unit_rows(gen, n_i, e, device)}
    return {"params": params, "library": library}
