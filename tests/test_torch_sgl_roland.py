"""SGL crossed with ROLAND (``make_dynamic(SGLPlugin, "roland")``) through
the port's normal path, on the CPU at a small size: the stage set-up that
``staged_dynamic`` runs (:func:`dynamic_stage`), ``EdgeTrainer.step``
against the plain reference of the cross
(``perfbench/reference/edge_dynamic.py``), and the spans and counters of the
views, the InfoNCE and the GRU.

The model runs as on the card: kernel A's path (``segsum_impl="fused"``,
whose plain version runs here) with bfloat16 rows and weights, float32
sums, the GRU and the InfoNCE in float32. The reference rounds the same
operands to bfloat16, so the two differ only in the order of their float32
sums.
"""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np
import pytest
import torch

from perfbench.loops.dynamic_steps import step_salts
from perfbench.reference import edge_dynamic as ref
from ragraph_tpu_torch.cli.edge import model_class
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.models.edge import (EdgeModelConfig, EvolveGCNO,
                                           Roland, dynamic_stage)
from ragraph_tpu_torch.models.edge.base import unique_padded
from ragraph_tpu_torch.train import profiling
from ragraph_tpu_torch.train.trainer import EdgeTrainer, param_leaves

USERS, ITEMS, ROWS, E, LAYERS, BATCH = 64, 128, 900, 16, 3, 128
CPU = torch.device("cpu")
# a loss: float32 sums in another order, over a few hundred terms
LOSS_RTOL = 1e-5
# a leaf's gradient, as ||g - g_ref|| / ||g_ref||: the same, and now and then
# an f32 sum a last bit apart that rounds to the other bfloat16 neighbour
GRAD_RTOL = 1e-4
# a leaf's change after three Adam steps: Adam divides by sqrt(v), so an
# element whose gradient is near zero moves by up to lr either way
CHANGE_RTOL = 1e-3


def _cfg(**kw):
    base = dict(emb_size=E, num_layers=LAYERS, batch_size=BATCH,
                edge_dropout=0.5, lr=1e-3, weight_decay=1e-4,
                segsum_impl="fused", propagate_dtype="bf16")
    base.update(kw)
    return EdgeModelConfig(**base)


@pytest.fixture(scope="module")
def stage():
    """A stage's interactions, dataset (padded as ``staged_dynamic`` pads
    it) and starting tables (unit rows)."""
    rng = np.random.default_rng(20)
    users = rng.integers(0, USERS, ROWS)
    items = rng.integers(0, ITEMS, ROWS)
    times = np.sort(1_600_000_000 + rng.integers(0, 10 * 86400, ROWS))
    ds = load_edge_dataset(
        list(zip(users.tolist(), items.tolist(), times.tolist())), [],
        num_users=USERS, num_items=ITEMS, phase="finetune", user_hist=[[]],
        pad_edges_to=-(-2 * ROWS // 256) * 256)
    g = torch.Generator().manual_seed(3)

    def unit(n):
        x = torch.randn(n, E, generator=g)
        return x / x.norm(dim=1, keepdim=True)
    tables = {"user_embedding": unit(USERS), "item_embedding": unit(ITEMS)}
    return {"users": users, "items": items, "times": times}, ds, tables


def _stage_model(stage, **kw):
    _, ds, tables = stage
    return dynamic_stage(model_class("SGL", dynamic="roland"),
                         lambda phase: _cfg(), ds, tables,
                         torch.Generator().manual_seed(7), mode="roland",
                         device="cpu", **kw)


@pytest.mark.parametrize("carried", [False, True])
def test_dynamic_stage_sets_the_meta_layers(stage, carried):
    meta_params = None
    if carried:
        _, first = _stage_model(stage)
        meta_params = {k: (v * 0.5 if not isinstance(v, dict)
                           else {n: t + 1.0 for n, t in v.items()})
                       for k, v in first.items()}
    model, params = _stage_model(stage, meta_params=meta_params)
    assert type(model).__name__ == "SGLPlugin_roland"
    assert set(params) == {"user_embedding", "item_embedding", "gru"}
    if carried:
        # the previous stage's tables and GRU carry into the new params
        for name, t in param_leaves(meta_params):
            assert torch.equal(dict(param_leaves(params))[name], t), name
    want = model.propagated_plain(params)
    assert len(model.meta_layers) == LAYERS + 1
    for got, w in zip(model.meta_layers, want):
        assert torch.equal(got, w)
        assert not got.requires_grad
    assert torch.equal(model.meta_layers[0], torch.cat(
        [params["user_embedding"], params["item_embedding"]]))


def test_step_matches_the_plain_reference(stage):
    inputs, ds, tables = stage
    model, params = _stage_model(stage)
    trainer = EdgeTrainer(model, ds, logger=lambda *_: None)
    start = {n: t.clone() for n, t in param_leaves(params)}
    leaves, opt = trainer.prepare(params)
    gen = torch.Generator().manual_seed(11)
    batches, states, losses, first_grad = [], [], [], None
    for b in list(ds.train_batches(BATCH, np.random.default_rng(5)))[:3]:
        states.append(gen.get_state())
        batches.append(b)
        loss, _ = trainer.step(leaves, opt,
                               tuple(torch.from_numpy(a) for a in b), gen)
        losses.append(float(loss))
        if first_grad is None:
            first_grad = {n: t.grad.clone() for n, t in param_leaves(leaves)}

    cfg = dict(num_users=USERS, num_items=ITEMS, hour_interval=1.0,
               num_layers=LAYERS, edge_dropout=0.5, view_keep=0.9, temp=0.2,
               lbd=0.1, weight_decay=1e-4, lr=1e-3, adam_betas=[0.9, 0.999],
               adam_eps=1e-8)
    r_model = ref.build(cfg, "finetune", {"train": inputs},
                        {"params": params}, CPU, "bf16")
    for got, want in zip(model.meta_layers, r_model.meta_layers):
        assert (got - want).norm() <= 1e-6 * want.norm()
    r_loss, r_grad, r_change = ref.train_steps(r_model, params, batches,
                                               step_salts(states, CPU))
    assert losses == pytest.approx(r_loss, rel=LOSS_RTOL)
    assert set(r_grad) == set(first_grad) == {
        "user_embedding", "item_embedding", "gru.w_ih", "gru.w_hh",
        "gru.b_ih", "gru.b_hh"}
    for n, want in r_grad.items():
        assert want.norm() > 0, n
        assert (first_grad[n] - want).norm() <= GRAD_RTOL * want.norm(), n
    for n, t in param_leaves(leaves):
        change = t.detach() - start[n]
        want = r_change[n]
        assert (change - want).norm() <= CHANGE_RTOL * want.norm(), n


def _fresh_recording():
    """A span with tracing off: the next recording starts anew."""
    with profiling.span("off"):
        pass


@pytest.fixture(autouse=True)
def _leave_no_recording_open():
    # the profiling store keeps a recording until a span sees tracing off;
    # a later test (in this process) must not find this file's spans in it
    yield
    _fresh_recording()


def _recorded_step(model, params, ds):
    _fresh_recording()
    trainer = EdgeTrainer(model, ds, logger=lambda *_: None)
    leaves, opt = trainer.prepare(params)
    users, pos, neg = next(ds.train_batches(BATCH,
                                            np.random.default_rng(1)))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.step(leaves, opt, tuple(torch.from_numpy(a)
                                        for a in (users, pos, neg)),
                     torch.Generator().manual_seed(2))
    return profiling.recorded(), users, pos


def test_spans_and_counters_of_the_views_infonce_and_gru(stage):
    _, ds, _ = stage
    _fresh_recording()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model, params = _stage_model(stage)
    assert [s.name for s in profiling.recorded().spans
            if s.parent is None and s.name != "gc"] == ["roland.meta"]
    rec, users, pos = _recorded_step(model, params, ds)
    names = [s.name for s in rec.spans]
    # three forwards of three layers, each layer's GRU a span; two of the
    # forwards inside the views' span
    assert names.count("roland.gru") == 9
    assert sum(s.parent == "sgl.views" for s in rec.spans
               if s.name == "edge_weights") == 2
    assert names.count("sgl.views") == 1 and names.count("infonce") == 1
    # the three mask draws and the three forwards' weights
    assert names.count("edge_weights") == 4
    assert rec.counts["roland.gru_rows"] == 9 * (USERS + ITEMS)
    assert rec.counts["infonce.rows"] == len(np.unique(users)) \
        + len(np.unique(pos))


@pytest.mark.parametrize("cls,grus", [(Roland, 3), (EvolveGCNO, 1)])
def test_the_standalone_dynamic_models_record_their_gru(stage, cls, grus):
    _, ds, tables = stage
    model, params = dynamic_stage(
        cls, lambda phase: _cfg(), ds, tables,
        torch.Generator().manual_seed(7),
        mode="roland" if cls is Roland else "evolvegcn_o", device="cpu")
    rec, _, _ = _recorded_step(model, params, ds)
    assert [s.name for s in rec.spans].count("roland.gru") == grus
    assert rec.counts["roland.gru_rows"] == grus * (USERS + ITEMS)


def _unique_padded_with_sync(x, size):
    """``unique_padded`` as it was: ``torch.unique``, whose length the host
    reads."""
    vals = torch.unique(x)[:size]
    out = torch.full((size,), -1, dtype=x.dtype, device=x.device)
    out[:len(vals)] = vals
    valid = out >= 0
    return torch.where(valid, out, 0), valid


@pytest.mark.parametrize("n,high,size,low", [
    (2048, 117450, 2048, 0),     # a batch's users: few repeats
    (2048, 300, 2048, 0),        # many repeats, padded
    (50, 10, 3, 0),              # more distinct values than size: cut
    (300, 40, 20, -20),          # negative values read as padding
    (1, 5, 4, 0), (0, 5, 4, 0)])
def test_unique_padded_is_the_old_function_bit_for_bit(n, high, size, low):
    x = torch.randint(low, high, (n,),
                      generator=torch.Generator().manual_seed(n + size))
    got, want = unique_padded(x, size), _unique_padded_with_sync(x, size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
