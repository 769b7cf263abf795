"""The training loop: ``EdgeTrainer.step`` on the batches of the dataset's
``train_batches`` through ``train/prefetch.py`` and
``EdgeTrainer._to_device``, epoch after epoch, as ``EdgeTrainer.train``
runs them, without its evaluation. The unit is a step; ``step_ms`` is the
window over the steps completed in it.

Set-up drives the first four steps through the same call and feed and
keeps what the reference follows: the first three batches, the
generator's state before each step, the losses, the first gradient as
Adam holds it, the change after three steps, and, where the model
retrieves, the first step's retrieval over every node (the ids kernel C
returns and ``_retrieved_mean``'s output, taken as the timed call makes
them).

The numbers compared with the reference (which follows steps 1-3 from the
same tables, batches and dropout draws):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, against the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- ``update_gap``: the same of the norms of each leaf's change after three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's;
- ``feed_faults``: batch rows that are not interactions of the split, and
  negatives that are;
- where the model retrieves, ``retrieval_miss``: the share of the first
  step's retrieved ids, over every node, that the reference's top k lacks;
  ``rag_mean_gap``: ``||M - M_ref|| / ||M_ref||`` of their means.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from perfbench import check, traffic
from perfbench.programs.ragraph_edge import sync

TEST_ROWS = False
FEED_DEPTH = 2            # EdgeTrainer.train's prefetch depth
FIRST_STEPS = 4           # set-up steps; the reference follows three
MODEL_MODULE = "ragraph_tpu_torch.models.edge.ragraph_edge"


def _epochs(prog, rng):
    """Batches epoch after epoch, each epoch's through its own prefetch,
    as ``EdgeTrainer.train`` makes them."""
    from ragraph_tpu_torch.train.prefetch import prefetch
    while True:
        with prefetch(prog.ds.train_batches(
                prog.mc.batch_size, rng, n_negs=1,
                drop_remainder=True), depth=FEED_DEPTH) as batches:
            yield from batches


def _train_one(prog):
    with prog.spans.span("batch_wait"):
        users, pos, neg = next(prog.feed)
    with prog.spans.span("step"):
        batch = prog.trainer._to_device(users, pos, neg)
        loss, _ = prog.trainer.step(prog.params, prog.optimizer, batch,
                                    prog.generator)
    return (users, pos, neg), loss


@contextlib.contextmanager
def _retrieval_taken(prog, out: dict):
    """Keeps, on the host, the ids that the model's top-k call returns
    and the output of its ``_retrieved_mean`` while the block runs."""
    import importlib
    mod = importlib.import_module(MODEL_MODULE)
    topk, mean_fn = mod.cosine_topk, prog.model._retrieved_mean
    ids, means = [], []

    def cosine_topk(*args, **kwargs):
        scores, idx = topk(*args, **kwargs)
        ids.append(idx.to("cpu", torch.int64))
        return scores, idx

    def retrieved_mean(*args, **kwargs):
        m = mean_fn(*args, **kwargs)
        means.append(m.float().cpu())
        return m
    mod.cosine_topk = cosine_topk
    prog.model._retrieved_mean = retrieved_mean
    try:
        yield
    finally:
        mod.cosine_topk = topk
        del prog.model._retrieved_mean
    if ids and means:
        out["retrieval"] = (torch.cat(ids), means[0])


def setup(prog) -> None:
    from ragraph_tpu_torch.train.trainer import param_leaves
    prog.params, prog.optimizer = prog.trainer.prepare(prog.tables["params"])
    prog.generator = traffic.torch_generator(prog.seed, 4, prog.device)
    prog.feed = _epochs(prog, traffic.rng_for(prog.seed, 5))
    t0 = time.perf_counter()
    rec = {"batches": [], "gen_states": [], "losses": []}
    b1 = float(prog.cfg["adam_betas"][0])
    retrieves = prog.model.resource_keys is not None
    for t in range(1, FIRST_STEPS + 1):
        state = prog.generator.get_state()
        if t == 1 and retrieves:
            with _retrieval_taken(prog, rec):
                batch, loss = _train_one(prog)
        else:
            batch, loss = _train_one(prog)
        if t <= 3:
            rec["batches"].append(tuple(np.array(a) for a in batch))
            rec["gen_states"].append(state)
            rec["losses"].append(loss)
        if t == 1:
            # the first gradient as Adam holds it: m_1 = (1 - b1) g_1
            st = prog.optimizer.state
            rec["grad_norms"] = {
                n: float(st[x]["exp_avg"].norm() / (1.0 - b1))
                if x in st else 0.0
                for n, x in param_leaves(prog.params)}
        if t == 3:
            init = prog.tables["params"]
            rec["change_norms"] = {
                n: float((x.detach() - init[n]).norm())
                for n, x in param_leaves(prog.params)}
    rec["losses"] = [float(x) for x in rec["losses"]]
    prog.record = rec
    prog._stage("first_steps", t0)


def window(prog, seconds: float) -> float:
    sync(prog.device)
    t0 = time.perf_counter()
    with prog.spans.span("window"):
        while True:
            _train_one(prog)
            prog.units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(prog.device)
    return time.perf_counter() - t0


def measures(prog, window_s: float) -> dict:
    """The end-to-end measures of a window, by metric name before its
    first dot."""
    return {"step_ms": window_s * 1e3 / prog.units}


# -- correctness -----------------------------------------------------------

def salts(states, device) -> list[int]:
    """The dropout salt each step drew: the first draw of the step's
    generator state."""
    out = []
    for st in states:
        g = torch.Generator(device)
        g.set_state(st)
        out.append(int(torch.randint(0, 1 << 32, (), generator=g,
                                     device=device)))
    return out


def feed_faults(inputs: dict, batches: list, n_items: int, device) -> int:
    tr = inputs["train"]
    pairs = torch.unique(torch.from_numpy(tr["users"] * n_items
                                          + tr["items"]).to(device))

    def member(keys):
        x = torch.from_numpy(keys).to(device)
        i = torch.searchsorted(pairs, x).clamp_max(len(pairs) - 1)
        return pairs[i] == x
    bad = 0
    for users, pos, neg in batches:
        u = users.astype(np.int64) * n_items
        bad += int((~member(u + pos)).sum()) + int(member(u + neg).sum())
    return bad


def retrieval_miss(ids, ref_ids, block: int = 16384) -> float:
    """The share of ``ids``' entries that the same row of ``ref_ids``
    lacks."""
    ref_ids = ref_ids.to(ids.device)
    miss = 0
    for s in range(0, len(ids), block):
        a, b = ids[s:s + block], ref_ids[s:s + block]
        miss += int((~(a[:, :, None] == b[:, None, :]).any(-1)).sum())
    return miss / ids.numel()


def _run_reference(cell, prog, device, dtype: str):
    """The reference over the program's first three steps: ``(model,
    losses, first gradients, changes)``."""
    ref = cell["reference"]
    ref.no_tf32()
    model = ref.build(cell["config"], prog.phase, prog.inputs, prog.tables,
                      device, dtype)
    out = ref.train_steps(model, prog.tables["params"],
                          prog.record["batches"],
                          salts(prog.record["gen_states"], device))
    return (model, *out)


def readings(cell: dict, prog, device, dtype: str | None = None) -> dict:
    """The cell's numbers. With ``dtype`` (the control), the reference at
    that precision takes the program's place."""
    model, r_loss, r_grad, r_change = _run_reference(cell, prog, device,
                                                     "bf16")
    rg = {n: float(g.norm()) for n, g in r_grad.items()}
    med = statistics.median(rg.values())
    moved = [n for n in rg if rg[n] >= 1e-3 * med]
    rc = {n: float(r_change[n].norm()) for n in moved}
    if dtype is None:
        p = prog.record
        got = p.get("retrieval")
    else:
        c_model, loss, grad, change = _run_reference(cell, prog, device,
                                                     dtype)
        p = {"losses": loss,
             "grad_norms": {n: float(g.norm()) for n, g in grad.items()},
             "change_norms": {n: float(c.norm())
                              for n, c in change.items()}}
        got = c_model.first_retrieval
    out = {
        "loss_gap": max(check.rel(a, b, 1e-30) for a, b in
                        zip(p["losses"], r_loss)),
        "grad_gap": check.leaf_gaps(p["grad_norms"], rg, rg),
        "update_gap": check.leaf_gaps(p["change_norms"], rc, moved),
        "feed_faults": feed_faults(prog.inputs, prog.record["batches"],
                                   int(cell["config"]["num_items"]),
                                   device),
    }
    if model.first_retrieval is not None:
        r_ids, r_mean = model.first_retrieval
        if got is None:
            raise RuntimeError("the program retrieved nothing in its first "
                               "step")
        ids, mean = (x.to(device) for x in got)
        out["retrieval_miss"] = retrieval_miss(ids, r_ids)
        out["rag_mean_gap"] = float((mean.float() - r_mean).norm()
                                    / r_mean.norm())
    return out


def control(cell: dict, prog, device) -> dict:
    """The reference one precision below the configuration's (float8 with
    a per-tensor scale where it states bfloat16) in the program's
    place."""
    return readings(cell, prog, device, dtype="fp8")


# -- faults planted under the timed path -------------------------------------

@contextlib.contextmanager
def half_batch():
    """Half of each batch left out; the loss is the mean over the rest."""
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    orig = EdgeTrainer.step

    def step(self, params, optimizer, batch, generator, edge_masks=None):
        batch = tuple(t[: len(t) // 2] for t in batch)
        return orig(self, params, optimizer, batch, generator, edge_masks)
    EdgeTrainer.step = step
    try:
        yield
    finally:
        EdgeTrainer.step = orig


@contextlib.contextmanager
def state_unchanged():
    """A step that returns its state unchanged: no Adam update."""
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    orig = EdgeTrainer.step

    def step(self, params, optimizer, batch, generator, edge_masks=None):
        real = optimizer.step
        optimizer.step = lambda *a, **k: None
        try:
            return orig(self, params, optimizer, batch, generator,
                        edge_masks)
        finally:
            optimizer.step = real
    EdgeTrainer.step = step
    try:
        yield
    finally:
        EdgeTrainer.step = orig


@contextlib.contextmanager
def positive_negatives():
    """A feed whose negatives are the batch's positives."""
    from ragraph_tpu_torch.data.edgelist import EdgeDataset
    orig = EdgeDataset.train_batches

    def train_batches(self, *args, **kwargs):
        for users, pos, _ in orig(self, *args, **kwargs):
            yield users, pos, pos.copy()
    EdgeDataset.train_batches = train_batches
    try:
        yield
    finally:
        EdgeDataset.train_batches = orig


@contextlib.contextmanager
def retrieval_altered():
    """The retrieval's answer altered where it is made: each query of a
    chunk gets the next query's ids."""
    import importlib
    mod = importlib.import_module(MODEL_MODULE)
    orig = mod.cosine_topk

    def cosine_topk(*args, **kwargs):
        scores, idx = orig(*args, **kwargs)
        return torch.roll(scores, 1, dims=0), torch.roll(idx, 1, dims=0)
    mod.cosine_topk = cosine_topk
    try:
        yield
    finally:
        mod.cosine_topk = orig


def faults(cell: dict) -> dict:
    """The faults this cell can have, by name."""
    out = {"half_batch": half_batch, "state_unchanged": state_unchanged,
           "positive_negatives": positive_negatives}
    if cell["mix"]["phase"] == "finetune":
        out["retrieval_altered"] = retrieval_altered
    return out
